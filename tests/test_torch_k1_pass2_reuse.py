"""K1's second pass returns the first pass's answer on the tiles the first
refraction left with no live ray, on the CPU (the twin; the kernel on the
card: chip_smoke phase v).

A ray that the first refraction leaves dead enters the second as it entered
the first, bit for bit, and K1's answer for a 128-ray tile is a function of
the tile's rays and the tables alone.  So `trace_through_lens` hands the
second search a prior (`intersect.WinnerPrior`: the live rays, the first
search's winners and distances), and a tile without a live ray returns it.
Here:

* on a tiled robot beam that crosses the lens's silhouette (dead, mixed and
  all-live tiles) and on the car-lamp fan, the second pass with the prior
  equals the second pass without it, bit for bit: K1's winners and
  distances, the statuses and the rays it leaves; so do a fit's loss and
  gradients, in one chunk and in several;
* `reuse_counts` counts the dead tiles worked out from the first statuses;
* a tile with a single live ray is searched in full;
* K2's route (P > 1024) takes no prior and counts nothing;
* a prior of the wrong shape, type or device is refused.
"""
import numpy as np
import pytest
import torch

from cbtr_tpu_torch.models import scenes
from cbtr_tpu_torch.models.lens_model import LensParams, lens_loss
from cbtr_tpu_torch.ops import cuda_sweep as cs
from cbtr_tpu_torch.ops import intersect as ix
from cbtr_tpu_torch.optics import lens
from cbtr_tpu_torch.render.emitters import DeviceEmitter
from cbtr_tpu_torch.utils import profiling

torch.set_num_threads(2)

# a 64^2 beam in 16x8 tiles, narrower than the scene's 1.8 so that some
# tiles lie wholly inside the silhouette: 13 dead, 17 mixed, 2 all-live
_BEAM_RES, _BEAM_WIDTH = 64, 0.9
# the car-lamp cell's source (portbench/configs/carlamp450.json), 4,096 of
# its 16,777,216 rays, strided
_FAN = {"belts": 64, "n_rays": 1 << 24}
_FAN_RAYS = 4096


def _rays(case):
    if case == "robot_beam":
        return scenes.scene_ortho_grid(_BEAM_RES, _BEAM_WIDTH).rays_at(
            torch.arange(_BEAM_RES * _BEAM_RES))
    origin = tuple(float(x) for x in np.asarray(scenes.LENS_CENTER) - (3.0, 0.0, 0.0))
    em = DeviceEmitter(origin=origin, seed=3900000001, **_FAN)
    start, direction, _ = em.rays_at(torch.arange(0, _FAN["n_rays"],
                                                  _FAN["n_rays"] // _FAN_RAYS))
    return start, direction


def _tiles(flags):
    """[T, 128] bool of R flags, padded with False."""
    T = -(-flags.shape[0] // cs.TILE_R)
    padded = torch.zeros(T * cs.TILE_R, dtype=torch.bool)
    padded[:flags.shape[0]] = flags
    return padded.reshape(T, cs.TILE_R)


@pytest.fixture(scope="module")
def robot():
    return scenes.robot_lens_scene(res=1, device="cpu")


@pytest.fixture(scope="module")
def passes(robot):
    """case -> the first refraction (s1, d1, st1, K1's answers) and the
    second with and without the prior (its rays, statuses, K1's answers;
    the reuse counter of the one with)."""
    out = {}
    n = robot.refractive_index
    with torch.no_grad():
        for case in ("robot_beam", "carlamp_fan"):
            s, d = _rays(case)
            first = []
            s1, d1, st1 = lens.refract_rays(robot.patches, n, s, d, lens.REFRACT_INSIDE,
                                            winners=first)
            prior = ix.WinnerPrior(st1 == lens.REFRACT_INSIDE, *first[0])
            k1_with, k1_without = [], []
            cs.reset_pair_counts()
            with profiling.counting():
                with_ = lens.refract_rays(robot.patches, n, s1, d1, lens.REFRACT_OUTSIDE,
                                          prior=prior, winners=k1_with)
            reuse = cs.reuse_counts()
            cs.reset_pair_counts()
            without = lens.refract_rays(robot.patches, n, s1, d1, lens.REFRACT_OUTSIDE,
                                        winners=k1_without)
            out[case] = {"s1": s1, "d1": d1, "st1": st1, "prior": prior,
                         "with": with_ + k1_with[0], "without": without + k1_without[0],
                         "reuse": reuse}
    return out


@pytest.mark.parametrize("case", ["robot_beam", "carlamp_fan"])
def test_pass2_with_prior_equals_without(passes, case):
    """Every ray's K1 winner and distance, status and outgoing ray, bit for
    bit; the beam holds dead, mixed and all-live tiles, the fan mostly dead
    ones."""
    p = passes[case]
    tiles = _tiles(p["st1"] == lens.REFRACT_INSIDE)
    dead, full = ~tiles.any(dim=1), tiles.all(dim=1)
    assert int(dead.sum()) > 0 and int((~dead & ~full).sum()) > 0
    if case == "robot_beam":
        assert int(full.sum()) > 0
    names = ("s2", "d2", "status", "win", "dist")
    for name, a, b in zip(names, p["with"], p["without"]):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    # dead rays pass through unchanged, and their first answers are the second's
    dead_rays = p["st1"] != lens.REFRACT_INSIDE
    assert torch.equal(p["with"][3][dead_rays], p["prior"].win[dead_rays])
    assert torch.equal(p["with"][4][dead_rays].view(torch.int32),
                       p["prior"].dist[dead_rays].view(torch.int32))


@pytest.mark.parametrize("case", ["robot_beam", "carlamp_fan"])
def test_reuse_counts_are_the_dead_tiles(passes, case):
    """(reused, launched with a prior): the tiles of the first statuses with
    no live ray, and every tile."""
    p = passes[case]
    tiles = _tiles(p["st1"] == lens.REFRACT_INSIDE)
    assert p["reuse"] == (int((~tiles.any(dim=1)).sum()), tiles.shape[0])


def test_single_live_ray_tile_is_searched_in_full(robot, passes):
    """A prior whose answers are all wrong and whose only live ray is one of
    tile k: tile k's 128 rays read the search's answers, every other ray the
    prior's; one tile of T searched."""
    p = passes["robot_beam"]
    s1, d1 = p["s1"], p["d1"]
    R = s1.shape[0]
    k = 9
    live = torch.zeros(R, dtype=torch.bool)
    live[k * cs.TILE_R + 77] = True
    wrong = ix.WinnerPrior(live, torch.full((R,), 7, dtype=torch.int32),
                           torch.full((R,), -1.5, dtype=torch.float32))
    cs.reset_pair_counts()
    with profiling.counting():
        got = cs.sweep_select(robot.patches, s1, d1, prior=wrong)
    assert cs.reuse_counts() == (R // cs.TILE_R - 1, R // cs.TILE_R)
    cs.reset_pair_counts()
    want = cs.sweep_select(robot.patches, s1, d1)
    tile = slice(k * cs.TILE_R, (k + 1) * cs.TILE_R)
    for a, b in zip(got, want):
        assert torch.equal(a[tile], b[tile])
    rest = torch.ones(R, dtype=torch.bool)
    rest[tile] = False
    assert bool((got[1][rest] == 7).all()) and bool((got[2][rest] == -1.5).all())
    # any_hit follows the distance: below BIG, a hit
    assert bool(got[0][rest].all())


def test_k2_route_takes_no_prior():
    """Above 1024 patches the winner search is K2: `intersect_rays` hands it
    no prior (a wrong one changes nothing), gives no K1 answers back and
    counts no reuse."""
    sc = scenes.robot_lens_scene(res=16, refine=True, device="cpu")
    assert sc.patches.num_patches > cs._FUSED_MAX_P
    s, d = sc.start.reshape(-1, 3), sc.direction.reshape(-1, 3)
    R = s.shape[0]
    wrong = ix.WinnerPrior(torch.zeros(R, dtype=torch.bool),
                           torch.full((R,), 7, dtype=torch.int32),
                           torch.full((R,), -1.5, dtype=torch.float32))
    winners = []
    cs.reset_pair_counts()
    with torch.no_grad(), profiling.counting():
        got = ix.intersect_rays(sc.patches, s, d, prior=wrong, winners=winners)
    assert cs.reuse_counts() == (0, 0) and winners == []
    assert cs.pair_counts()["winner"][0] > 0
    cs.reset_pair_counts()
    with torch.no_grad():
        want = ix.intersect_rays(sc.patches, s, d)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fault", ["short", "win_int64", "dist_f64", "live_uint8",
                                   "other_device"])
def test_bad_prior_is_refused(robot, passes, fault):
    """A prior of another length, type or device than the rays' raises."""
    p = passes["robot_beam"]
    prior = p["prior"]
    bad = {
        "short": lambda: ix.WinnerPrior(*(t[:-1] for t in prior)),
        "win_int64": lambda: prior._replace(win=prior.win.long()),
        "dist_f64": lambda: prior._replace(dist=prior.dist.double()),
        "live_uint8": lambda: prior._replace(live=prior.live.to(torch.uint8)),
        "other_device": lambda: prior._replace(live=prior.live.to("meta")),
    }[fault]()
    with pytest.raises(ValueError):
        cs.sweep_select(robot.patches, p["s1"], p["d1"], prior=bad)
    with pytest.raises(ValueError):
        cs.sweep_select_reference(robot.patches, p["s1"], p["d1"], prior=bad)


@pytest.mark.parametrize("chunk", [0, 1000])
def test_fit_loss_and_gradients_equal(robot, monkeypatch, chunk):
    """A fit step's loss and gradients through `trace_through_lens`, with the
    prior (reused tiles counted) and with K1 made to drop it, bit for bit;
    chunk 1000 cuts the 4,096 rays into five chunks that are no whole
    tiles."""
    s, d = _rays("robot_beam")
    target = torch.rand((32, 32), generator=torch.Generator().manual_seed(5))

    def step():
        params = LensParams(robot.patches, robot.refractive_index)
        loss = lens_loss(params, s, d, robot.screen_plane, target, resolution=32,
                         chunk_size=chunk)
        loss.backward()
        return loss.detach(), params.control_points.grad, params.refractive_index.grad

    cs.reset_pair_counts()
    with profiling.counting():
        got = step()
    reused, launched = cs.reuse_counts()
    cs.reset_pair_counts()
    assert 0 < reused < launched
    search = cs.sweep_select

    def dropped(*args, prior=None, **kwargs):
        return search(*args, **kwargs)

    monkeypatch.setattr(cs, "sweep_select", dropped)
    want = step()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert float(got[1].abs().sum()) > 0.0

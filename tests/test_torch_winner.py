"""The plain twin of the winner kernel K2 against the JAX package, and the
routing of `intersect_rays` above 1024 patches.

Same patches (the JAX package's, handed over as NumPy) and the same rays
(made with numpy from a seed, or the JAX scene's ray grid) go through the
port's `sweep_winner_reference` and through the JAX package's winner kernel
(`sweep_winner_pallas(interpret=True)`, as tests/test_pallas_sweep.py runs
it on the CPU) and its XLA path (`sweep_codes_xla` + `select_candidates`).

Bar: any_hit equal on every ray, the winning patch equal on every common
hit, the winning distance allclose rtol/atol 1e-4 against the XLA path (the
same Newton arithmetic, a few f32 sums associated differently).  Against
the Pallas kernel the distances are held to rtol 1e-3 / atol 2e-3: its body
uses an approximate rsqrt, which moves the refined robot's distances by up
to 1.5e-3 (the XLA path and the twin agree to 3.6e-5 there).
"""
import numpy as np
import pytest
import torch

from cbtr_tpu.bezier import build_from_trimesh as jax_build
from cbtr_tpu.harness.measure import preprocess as jax_preprocess
from cbtr_tpu.mesh.core import make_unit_sphere as jax_sphere
from cbtr_tpu.models import scenes as jax_scenes
from cbtr_tpu.ops import intersect as jax_ix
from cbtr_tpu.ops import pallas_sweep as jax_ps

from cbtr_tpu_torch.convert import patches_from_numpy
from cbtr_tpu_torch.ops import cuda_sweep as cs
from cbtr_tpu_torch.ops import cuda_winner as cw
from cbtr_tpu_torch.ops import intersect as ix

torch.set_num_threads(2)


def _numpy_leaves(patches):
    return {k: np.asarray(v) for k, v in patches._asdict().items()}


def _fan(n, seed):
    """Random ray fan at the lens (tests/test_pallas_sweep.py's fixture)."""
    rng = np.random.default_rng(seed)
    start = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    start[:, 0] -= 3.0
    target = rng.normal(size=(n, 3)).astype(np.float32) * 0.4
    d = target - start
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return start, d


def _port(fn, patches, start, direction):
    return tuple(x.numpy() for x in fn(patches, torch.tensor(start),
                                       torch.tensor(direction)))


@pytest.fixture(scope="module")
def sphere():
    ref = jax_build(jax_preprocess(jax_sphere(7, 3), use_native=False))
    return ref, patches_from_numpy(_numpy_leaves(ref))


@pytest.fixture(scope="module")
def refined():
    """The refined robot (P = 1800) at 32^2 rays, with the JAX package's
    two winner searches computed once (about 8 s and 10 s on the CPU)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CBTR_NATIVE", "0")
        scene = jax_scenes.robot_lens_scene(res=32, refine=True)
    ref = scene.patches
    start, d = np.asarray(scene.start), np.asarray(scene.direction)
    pallas = jax_ps.sweep_winner_pallas(ref, start, d, interpret=True)
    code, dist = jax_ix.sweep_codes_xla(ref, start, d)
    xla = jax_ix.select_candidates(code, dist, ref.neighbours)
    return dict(ref=ref, port=patches_from_numpy(_numpy_leaves(ref)), start=start,
                d=d, pallas=[np.asarray(x) for x in pallas],
                xla=[np.asarray(x) for x in xla])


@pytest.fixture(scope="module")
def cases(sphere, refined):
    """name -> (jax patches, port patches, start, direction, pallas, xla);
    the reference results of the sphere fans are computed on demand."""
    out = {}
    for name, (n, seed) in (("sphere64", (64, 7)), ("sphere1024", (1024, 3))):
        out[name] = (sphere[0], sphere[1]) + _fan(n, seed) + (None, None)
    r = refined
    out["refined1024"] = (r["ref"], r["port"], r["start"], r["d"], r["pallas"], r["xla"])
    return out


@pytest.fixture(scope="module")
def twin(cases):
    """case -> the port twin's result, computed once per case."""
    memo = {}

    def get(case):
        if case not in memo:
            _, port_p, start, d, _, _ = cases[case]
            memo[case] = _port(cw.sweep_winner_reference, port_p, start, d)
        return memo[case]

    return get


def _assert_winners_agree(port, ref, rtol, atol, min_hits=16):
    any_p, win_p, d_p = port
    any_r, win_r, d_r = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(any_p, any_r)
    assert any_p.sum() >= min_hits, "fixture too weak"
    np.testing.assert_array_equal(win_p[any_p], win_r[any_p])
    np.testing.assert_allclose(d_p[any_p], d_r[any_p], rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", ["sphere64", "sphere1024", "refined1024"])
def test_winner_twin_matches_pallas_winner_kernel(cases, twin, case):
    ref_p, _, start, d, pallas, _ = cases[case]
    if pallas is None:
        pallas = jax_ps.sweep_winner_pallas(ref_p, start, d, interpret=True)
    _assert_winners_agree(twin(case), pallas, rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("case", ["sphere1024", "refined1024"])
def test_winner_twin_matches_xla_path(cases, twin, case):
    ref_p, _, start, d, _, xla = cases[case]
    if xla is None:
        code, dist = jax_ix.sweep_codes_xla(ref_p, start, d)
        xla = jax_ix.select_candidates(code, dist, ref_p.neighbours)
    _assert_winners_agree(twin(case), xla, rtol=1e-4, atol=1e-4, min_hits=100)


def test_refined_fixture_size(refined):
    """The JAX package's own two searches agree on the refined robot (208
    hits), and its P is above the fused path's cap."""
    assert refined["port"].num_patches == 1800 > cs._FUSED_MAX_P
    assert refined["pallas"][0].sum() == refined["xla"][0].sum() == 208
    np.testing.assert_array_equal(refined["pallas"][1][refined["pallas"][0]],
                                  refined["xla"][1][refined["xla"][0]])


@pytest.mark.parametrize("case", ["sphere1024", "refined1024"])
def test_winner_twin_ray_chunking_is_invisible(cases, twin, case, monkeypatch):
    """The twin's chunk of whole tiles (forced to one 128-ray tile here)
    changes nothing: the counterpart of the JAX patch and ray chunking
    tests of the winner kernel."""
    _, port_p, start, d, _, _ = cases[case]
    monkeypatch.setattr(cw, "_REFERENCE_CHUNK_PAIRS", 1)
    chunked = _port(cw.sweep_winner_reference, port_p, start, d)
    for a, b in zip(twin(case), chunked):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["sphere1024", "refined1024"])
def test_tile_block_lists_chunking_is_invisible(cases, case, monkeypatch):
    """The list builder's tile chunks (forced to one tile) give the same
    counts and lists."""
    _, port_p, start, d, _, _ = cases[case]
    rays_t = cs.pad_rays(torch.tensor(start), torch.tensor(d))
    whole = cs.tile_block_lists(port_p, rays_t)
    monkeypatch.setattr(cs, "_LIST_CHUNK_PAIRS", 1)
    chunked = cs.tile_block_lists(port_p, rays_t)
    assert whole[0].sum() > 0
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_refined_tile_block_lists_match_jax(refined):
    """Against the JAX list builder at K2's block size, over the whole
    (unchunked) patch table."""
    rays_t = cs.pad_rays(torch.tensor(refined["start"]), torch.tensor(refined["d"]))
    counts, lists = cs.tile_block_lists(refined["port"], rays_t)
    c_ref, l_ref = jax_ps.tile_block_lists(refined["ref"], rays_t.numpy(), 128,
                                           jax_ps.WINNER_BLOCK_P)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(c_ref))
    np.testing.assert_array_equal(lists.numpy(), np.asarray(l_ref))


def test_winner_twin_tie_goes_to_lowest_patch_id(sphere):
    """tests/test_torch_sweep.py's tie fixture for K2's twin: a copy of the
    hit patch prepended as patch 0 ties the original (now w + 1) at a
    bit-equal distance, and the lowest id (0) wins."""
    ref_p, port_p = sphere
    start = np.array([[-3.0, 0.01, 0.02], [-3.0, -0.02, 0.01]], np.float32)
    d = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (2, 1))
    hit, w, _ = _port(cw.sweep_winner_reference, port_p, start, d)
    assert hit.all() and w[0] == w[1]
    leaves = _numpy_leaves(ref_p)
    tied = {k: np.concatenate([v[w[0]:w[0] + 1], v]) for k, v in leaves.items()}
    tied["neighbours"] = np.concatenate(
        [leaves["neighbours"][w[0]:w[0] + 1], leaves["neighbours"]]) + 1
    any_hit, win, dist = _port(cw.sweep_winner_reference, patches_from_numpy(tied),
                               start, d)
    assert any_hit.all() and (win == 0).all(), win


@pytest.mark.parametrize("case", ["sphere1024", "refined1024"])
def test_k1_and_k2_twins_agree(cases, twin, case):
    """The two candidate rules differ by design (K2 accepts a voted
    neighbour outside the evaluated blocks when its own sphere is hit); on
    these fixtures they pick the same winner on every ray."""
    _, port_p, start, d, _, _ = cases[case]
    k1 = _port(cs.sweep_select_reference, port_p, start, d)
    for a, b in zip(k1, twin(case)):
        np.testing.assert_array_equal(a, b)


def test_intersect_rays_routes_large_p_to_the_winner_twin(sphere, monkeypatch):
    """With the fused cap at 0 (the JAX test_intersect_rays_winner_path_end_to_end
    forces its winner path the same way) the CPU path runs K2's twin, and
    the RayHit matches JAX `intersect_rays(backend="xla")` at the bench bar
    (>= 0.999 any_hit, distances rtol/atol 1e-4)."""
    ref_p, port_p = sphere
    start, d = _fan(512, 13)
    calls = []
    twin = cw.sweep_winner_reference

    def counted(*args):
        calls.append(1)
        return twin(*args)

    monkeypatch.setattr(cs, "_FUSED_MAX_P", 0)
    monkeypatch.setattr(cw, "sweep_winner_reference", counted)
    got = ix.intersect_rays(port_p, torch.tensor(start), torch.tensor(d))
    plain = ix.intersect_rays(port_p, torch.tensor(start), torch.tensor(d),
                              backend="plain")
    assert len(calls) == 2
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    ref = jax_ix.intersect_rays(ref_p, start, d, backend="xla")
    hit_r = np.asarray(ref.what) == ix.WHAT_INTERSECT
    hit_p = got.what.numpy() == ix.WHAT_INTERSECT
    assert np.mean(hit_r == hit_p) >= 0.999
    both = hit_r & hit_p
    assert both.sum() >= 100
    np.testing.assert_array_equal(got.patch.numpy()[both], np.asarray(ref.patch)[both])
    np.testing.assert_allclose(got.distance.numpy()[both], np.asarray(ref.distance)[both],
                               rtol=1e-4, atol=1e-4)


def test_cpu_wrapper_runs_the_twin_and_launch_refuses_cpu(sphere):
    """On CPU tensors `sweep_winner` is the twin and never builds or
    launches; the launch itself refuses CPU tables."""
    _, port_p = sphere
    start, d = (torch.tensor(x) for x in _fan(64, 7))
    before = cw.sweep_winner.launches
    got = cw.sweep_winner(port_p, start, d)
    want = cw.sweep_winner_reference(port_p, start, d)
    assert cw.sweep_winner.launches == before and "winner" not in cs._libraries
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="CUDA"):
        cw.launch(cw.prepare_inputs(port_p, start, d))
    with pytest.raises(ValueError, match="CUDA"):
        cs.launch(cs.prepare_inputs(port_p, start, d))
    assert "winner" not in cs._libraries and "sweep_select" not in cs._libraries

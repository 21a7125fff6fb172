"""The plain twin of the per-pair sweep kernel K3 against the JAX package,
and the cull parameters (block size, AABB leg) of the list builder.

Same patches (the JAX package's, handed over as NumPy) and the same rays
(made with numpy from a seed, or the JAX scene's ray grid) go through the
port's `cuda_codes.sweep_codes_reference` and through the JAX package's
staged kernel (`sweep_codes_pallas(interpret=True)`, as
tests/test_pallas_sweep.py runs it on the CPU).

Bars:
* block lists: counts and lists equal exactly (the same f32 sphere and slab
  tests);
* per-pair codes: equal on > 99.5% of pairs, distances on the pairs both
  call cIntersect within rtol 1e-3 / atol 2e-3 (the JAX suite's own bar:
  the Pallas body uses an approximate rsqrt).  Measured: 0 of 32,256 pairs
  differ on the sphere fan, 14 of 460,800 on the robot 32^2 grid;
* staged winners (codes, then `select_candidates`): any_hit equal on
  >= 99.9% of rays and the winner equal on every common hit, leaving out
  the 2 robot rays on which the JAX package's own Pallas kernel and its XLA
  path disagree (a fault of the reference, see test_torch_sweep.py); the
  port's staged winners equal the XLA path's on every ray.
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
from cbtr_tpu_torch.ops import cuda_codes as cc
from cbtr_tpu_torch.ops import cuda_sweep as cs
from cbtr_tpu_torch.ops import cuda_winner as cw
from cbtr_tpu_torch.ops import intersect as ix

torch.set_num_threads(2)


def _numpy_leaves(patches):
    return {k: np.asarray(v) for k, v in patches._asdict().items()}


def _fan(n, seed):
    """Random ray fan at the lens (tests/test_pallas_sweep.py:21-35)."""
    rng = np.random.default_rng(seed)
    start = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    start[:, 0] -= 3.0
    target = rng.normal(size=(n, 3)).astype(np.float32) * 0.4
    d = target - start
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return start, d


@pytest.fixture(scope="module")
def cases():
    """name -> dict(ref, port, start, d, Pallas codes, XLA winners); the
    XLA path (a compile of several seconds) only for the robot."""
    sphere = jax_build(jax_preprocess(jax_sphere(7, 3), use_native=False))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CBTR_NATIVE", "0")
        robot = jax_scenes.robot_lens_scene(res=32)
    out = {}
    for name, ref, (start, d) in (
        ("sphere256", sphere, _fan(256, 3)),
        ("robot1024", robot.patches,
         (np.asarray(robot.start), np.asarray(robot.direction))),
    ):
        out[name] = dict(
            ref=ref, port=patches_from_numpy(_numpy_leaves(ref)), start=start, d=d,
            pallas=[np.asarray(x) for x in
                    jax_ps.sweep_codes_pallas(ref, start, d, interpret=True)])
    code, dist = jax_ix.sweep_codes_xla(robot.patches, robot.start, robot.direction)
    out["robot1024"]["xla"] = [np.asarray(x) for x in jax_ix.select_candidates(
        code, dist, robot.patches.neighbours)]
    return out


def _t(x):
    return torch.tensor(x)


def _differ(a, b):
    """Rays whose winners differ: any_hit, or the patch where both hit."""
    return (a[0] != b[0]) | (a[0] & b[0] & (a[1] != b[1]))


@pytest.mark.parametrize("case", ["sphere256", "robot1024"])
def test_block32_lists_match_jax_tile_lists_cr(cases, case):
    """K3's lists (block 32) against `_tile_lists_cr` with lo and hi, as
    `sweep_codes_pallas` builds them (pallas_sweep.py:912-915), over the
    port's patch padding (a multiple of 128)."""
    c = cases[case]
    rays_t = cs.pad_rays(_t(c["start"]), _t(c["d"]))
    counts, lists = cs.tile_block_lists(c["port"], rays_t, block_p=cc.BLOCK_P)
    ref = c["ref"]
    center, radius = jax_ps.patch_spheres(ref)
    lo, hi = jax_ps._patch_boxes(ref.control_points, center, radius)
    pad = (-ref.num_patches) % 128
    pad2 = ((0, pad), (0, 0))
    c_ref, l_ref = jax_ps._tile_lists_cr(
        np.pad(center, pad2), np.pad(radius, (0, pad)), rays_t.numpy(), cc.BLOCK_P,
        np.pad(lo, pad2), np.pad(hi, pad2))
    assert lists.shape == (cs.pack_patch_table(c["port"]).shape[0] // 32,
                           rays_t.shape[1] // cs.TILE_R)
    assert counts.sum() > 0
    np.testing.assert_array_equal(counts.numpy(), np.asarray(c_ref))
    np.testing.assert_array_equal(lists.numpy(), np.asarray(l_ref))


@pytest.mark.parametrize("block_p", [16, 32])
@pytest.mark.parametrize("use_aabb", [False, True])
@pytest.mark.parametrize("case", ["sphere256", "robot1024"])
def test_lists_match_jax_tile_block_lists(cases, case, block_p, use_aabb):
    c = cases[case]
    rays_t = cs.pad_rays(_t(c["start"]), _t(c["d"]))
    counts, lists = cs.tile_block_lists(c["port"], rays_t, block_p, use_aabb)
    c_ref, l_ref = jax_ps.tile_block_lists(c["ref"], rays_t.numpy(), 128, block_p,
                                           use_aabb)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(c_ref))
    np.testing.assert_array_equal(lists.numpy(), np.asarray(l_ref))


def test_aabb_leg_only_removes_blocks(cases):
    """Sphere-only lists are a superset: the AABB leg only drops blocks."""
    c = cases["robot1024"]
    rays_t = cs.pad_rays(_t(c["start"]), _t(c["d"]))
    P_pad = cs.pack_patch_table(c["port"]).shape[0]
    both = [cs.listed_blocks(*cs.tile_block_lists(c["port"], rays_t, 32, aabb), P_pad, 32)
            for aabb in (False, True)]
    assert not (both[1] & ~both[0]).any()
    assert both[1].sum() < both[0].sum()


@pytest.mark.parametrize("case", ["sphere256", "robot1024"])
def test_codes_twin_matches_pallas_kernel(cases, case):
    c = cases[case]
    code, dist = (x.numpy() for x in
                  cc.sweep_codes_reference(c["port"], _t(c["start"]), _t(c["d"])))
    code_r, dist_r = c["pallas"]
    assert code.shape == code_r.shape == (len(c["start"]), c["port"].num_patches)
    assert code.dtype == np.int32 and dist.dtype == np.float32
    assert np.mean(code == code_r) > 0.995
    assert (code != code_r).sum() <= (16 if case == "robot1024" else 0)
    both = ((code & 7) == ix.WHAT_INTERSECT) & ((code_r & 7) == ix.WHAT_INTERSECT)
    assert both.sum() >= 100
    np.testing.assert_allclose(dist[both], dist_r[both], rtol=1e-3, atol=2e-3)
    # pairs of skipped blocks hold (WHAT_NONE, 0.0) in both, and the two skip
    # the same pairs (an evaluated pair's distance is never exactly 0 here)
    skipped, skipped_r = dist == 0.0, dist_r == 0.0
    assert skipped_r.sum() > (1000 if case == "robot1024" else -1)
    assert (code[skipped] == ix.WHAT_NONE).all()
    assert np.mean(skipped == skipped_r) > 0.999


@pytest.mark.parametrize("case", ["sphere256", "robot1024"])
def test_staged_winners_match_jax(cases, case):
    c = cases[case]
    code, dist = cc.sweep_codes_reference(c["port"], _t(c["start"]), _t(c["d"]))
    got = [x.numpy() for x in ix.select_candidates(code, dist, c["port"].neighbours)]
    code_r, dist_r = c["pallas"]
    ref = [np.asarray(x) for x in
           jax_ix.select_candidates(code_r, dist_r, c["ref"].neighbours)]
    excused = _differ(ref, c["xla"]) if "xla" in c else np.zeros_like(ref[0])
    assert excused.sum() <= 2
    keep = ~excused
    assert np.mean(got[0][keep] == ref[0][keep]) >= 0.999
    assert _differ([g[keep] for g in got], [r[keep] for r in ref]).sum() == 0
    assert (got[0] & ref[0]).sum() >= 60
    if "xla" in c:    # against the reference's XLA path: every ray
        assert _differ(got, c["xla"]).sum() == 0
        hit = got[0]
        np.testing.assert_allclose(got[2][hit], c["xla"][2][hit], rtol=1e-4, atol=1e-4)


def test_twin_chunking_is_invisible(cases, monkeypatch):
    c = cases["robot1024"]
    whole = cc.sweep_codes_reference(c["port"], _t(c["start"]), _t(c["d"]))
    monkeypatch.setattr(cc, "_REFERENCE_CHUNK_PAIRS", 1)    # one tile a chunk
    chunked = cc.sweep_codes_reference(c["port"], _t(c["start"]), _t(c["d"]))
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_cpu_wrapper_runs_the_twin_and_launch_refuses_cpu(cases):
    c = cases["sphere256"]
    s, d = _t(c["start"][:200]), _t(c["d"][:200])
    before = cc.sweep_codes_cuda.launches
    got = cc.sweep_codes_cuda(c["port"], s, d)
    want = cc.sweep_codes_reference(c["port"], s, d)
    assert cc.sweep_codes_cuda.launches == before and "sweep_codes" not in cs._libraries
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    inputs = cc.prepare_inputs(c["port"], s, d)
    assert inputs.lists.shape == (inputs.patch_t.shape[0] // 32, 2)
    with pytest.raises(ValueError, match="CUDA"):
        cc.launch(inputs)
    with pytest.raises(ValueError, match="CUDA"):
        cc.launch(inputs, cc.filled_outputs(inputs))
    assert "sweep_codes" not in cs._libraries


@pytest.mark.parametrize("case", ["sphere256", "robot1024"])
def test_sphere_only_cull_keeps_k1_and_k2_winners(cases, case):
    """use_aabb=False (the bench's cull A/B) changes no winner of K1's or
    K2's twin on the fixtures."""
    c = cases[case]
    s, d = _t(c["start"]), _t(c["d"])
    for twin in (cs.sweep_select_reference, cw.sweep_winner_reference):
        with_aabb = twin(c["port"], s, d)
        sphere_only = twin(c["port"], s, d, use_aabb=False)
        for a, b in zip(with_aabb, sphere_only):
            assert torch.equal(a, b), twin.__name__
        assert with_aabb[0].sum() >= 60

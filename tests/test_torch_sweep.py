"""The plain twin of the sweep+select kernel against the JAX package.

Same patches (the JAX package's, handed over as NumPy) and the same rays
(made with numpy from a seed) go through the port's
`sweep_select_reference` and through the JAX package's fused Pallas kernel
(`sweep_select_pallas(interpret=True)`, as tests/test_pallas_sweep.py runs
it on the CPU) or its XLA path (`sweep_codes_xla` + `select_candidates`).

Bar (the bench's own, bench.py:174): any_hit equal on >= 99.9% of rays,
the winning patch equal where both hit, the winning distance allclose
rtol/atol 1e-4 (the Pallas body and the port's candidate code associate a
few f32 sums differently).  One exception, a fault of the reference: on the
robot's 32^2 grid the JAX package's own Pallas kernel and XLA path disagree
on 2 of 1024 rays (the Pallas body's approximate rsqrt and reassociated
sums send the Newton search on two near-border pairs to another point).
The port follows the XLA path on every ray there, so against the Pallas
kernel it is held to "disagree only where the kernel disagrees with XLA".
"""
import os
import subprocess
import sys

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


@pytest.fixture(scope="module")
def sphere():
    ref = jax_build(jax_preprocess(jax_sphere(7, 3), use_native=False))
    return ref, patches_from_numpy(_numpy_leaves(ref), device="cpu")


@pytest.fixture(scope="module")
def robot():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CBTR_NATIVE", "0")
        scene = jax_scenes.robot_lens_scene(res=32)
    ref = scene.patches
    return (ref, patches_from_numpy(_numpy_leaves(ref), device="cpu"),
            np.asarray(scene.start), np.asarray(scene.direction))


@pytest.fixture(scope="module")
def cases(sphere, robot):
    """name -> (jax patches, port patches, start, direction)."""
    s64 = _fan(64, 7)
    s1024 = _fan(1024, 3)
    return {
        "sphere64": (sphere[0], sphere[1]) + s64,
        "sphere1024": (sphere[0], sphere[1]) + s1024,
        "robot1024": robot,
    }


def _port(fn, patches, start, direction, **kw):
    return tuple(x.numpy() for x in fn(patches, torch.tensor(start),
                                       torch.tensor(direction), **kw))


def _assert_winners_agree(port, ref, min_hits=16, excused=None):
    """excused: [R] bool, rays on which a disagreement is the reference's
    (see the module docstring); they are left out of the comparison."""
    any_p, win_p, d_p = port
    any_r, win_r, d_r = (np.asarray(x) for x in ref)
    assert any_p.shape == any_r.shape
    if excused is not None:
        keep = ~excused
        any_p, win_p, d_p = any_p[keep], win_p[keep], d_p[keep]
        any_r, win_r, d_r = any_r[keep], win_r[keep], d_r[keep]
    assert np.mean(any_p == any_r) >= 0.999, np.mean(any_p == any_r)
    both = any_p & any_r
    assert both.sum() >= min_hits, "fixture too weak"
    np.testing.assert_array_equal(win_p[both], win_r[both])
    np.testing.assert_allclose(d_p[both], d_r[both], rtol=1e-4, atol=1e-4)


def _jax_xla_winners(ref_p, start, d):
    code, dist = jax_ix.sweep_codes_xla(ref_p, start, d)
    return jax_ix.select_candidates(code, dist, ref_p.neighbours)


@pytest.mark.parametrize("case", ["sphere64", "sphere1024", "robot1024"])
def test_culled_twin_matches_pallas_kernel(cases, case):
    ref_p, port_p, start, d = cases[case]
    ref = jax_ps.sweep_select_pallas(ref_p, start, d, interpret=True)
    xla = _jax_xla_winners(ref_p, start, d)
    got = _port(cs.sweep_select_reference, port_p, start, d)
    kernel_vs_xla = np.asarray(ref[0]) != np.asarray(xla[0])
    assert kernel_vs_xla.sum() <= (2 if case == "robot1024" else 0)
    _assert_winners_agree(got, ref, excused=kernel_vs_xla)
    # the culled twin and the reference's unculled XLA path: every ray
    _assert_winners_agree(got, xla)


@pytest.mark.parametrize("case", ["sphere1024", "robot1024"])
def test_culled_twin_at_block_32_matches_pallas_kernel(cases, case):
    """The twin at the JAX package's coarser block (32 patches, what
    `intersect_rays` takes above its ray cap) against
    `sweep_select_pallas(block_p=32)`: the same bar and the same excused
    rays as at block 16, and the lists equal to the JAX builder's."""
    ref_p, port_p, start, d = cases[case]
    ref = jax_ps.sweep_select_pallas(ref_p, start, d, interpret=True, block_p=32)
    xla = _jax_xla_winners(ref_p, start, d)
    got = _port(cs.sweep_select_reference, port_p, start, d, block_p=32)
    kernel_vs_xla = np.asarray(ref[0]) != np.asarray(xla[0])
    assert kernel_vs_xla.sum() <= (2 if case == "robot1024" else 0)
    _assert_winners_agree(got, ref, excused=kernel_vs_xla)
    rays_t = cs.pad_rays(torch.tensor(start), torch.tensor(d))
    counts, lists = cs.tile_block_lists(port_p, rays_t, 32)
    c_ref, l_ref = jax_ps.tile_block_lists(ref_p, rays_t.numpy(), 128, 32)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(c_ref))
    np.testing.assert_array_equal(lists.numpy(), np.asarray(l_ref))


@pytest.mark.parametrize("case", ["sphere1024", "robot1024"])
def test_unculled_twin_matches_xla_path(cases, case):
    ref_p, port_p, start, d = cases[case]
    _assert_winners_agree(
        _port(cs.sweep_select_reference, port_p, start, d, cull=False),
        _jax_xla_winners(ref_p, start, d))


def test_sweep_codes_match_xla(cases):
    """Per-pair gate-OFF codes (>= 99.9% equal) and distances."""
    ref_p, port_p, start, d = cases["robot1024"]
    code_r, dist_r = (np.asarray(x) for x in jax_ix.sweep_codes_xla(ref_p, start, d))
    code_p, dist_p = _port(ix.sweep_codes, port_p, start, d)
    assert np.mean(code_p == code_r) >= 0.999
    both = ((code_p & 7) == ix.WHAT_INTERSECT) & ((code_r & 7) == ix.WHAT_INTERSECT)
    assert both.sum() >= 100
    np.testing.assert_allclose(dist_p[both], dist_r[both], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["sphere1024", "robot1024"])
def test_tile_block_lists_match_jax(cases, case):
    ref_p, port_p, start, d = cases[case]
    rays_t = cs.pad_rays(torch.tensor(start), torch.tensor(d))
    counts, lists = cs.tile_block_lists(port_p, rays_t)
    c_ref, l_ref = jax_ps.tile_block_lists(ref_p, rays_t.numpy(), 128,
                                           jax_ps.FUSED_BLOCK_P)
    assert counts.sum() > 0
    np.testing.assert_array_equal(counts.numpy(), np.asarray(c_ref))
    np.testing.assert_array_equal(lists.numpy(), np.asarray(l_ref))


def test_packed_patch_table_matches_jax(cases):
    """Patch columns are copies (equal); the bounding-sphere columns are
    f32 means and norms summed in another order (rtol 1e-5)."""
    ref_p, port_p, _, _ = cases["robot1024"]
    got = cs.pack_patch_table(port_p).numpy()
    ref = np.asarray(jax_ps.pack_patch_table(ref_p, 128))
    assert got.shape == ref.shape == (512, 64)
    np.testing.assert_array_equal(got[:, :cs._ROW_BSPHERE], ref[:, :cs._ROW_BSPHERE])
    np.testing.assert_allclose(got[:, cs._ROW_BSPHERE:], ref[:, cs._ROW_BSPHERE:],
                               rtol=1e-5, atol=0)


def test_select_forms_agree(cases, monkeypatch):
    """The vote (one-hot product) and gather forms pick the same winners."""
    _, port_p, start, d = cases["robot1024"]
    code, dist = ix.sweep_codes(port_p, torch.tensor(start), torch.tensor(d))
    vote = ix.select_candidates(code, dist, port_p.neighbours)
    monkeypatch.setattr(ix, "_SELECT_MATMUL_MAX_P", 0)
    gather = ix.select_candidates(code, dist, port_p.neighbours)
    for a, b in zip(vote, gather):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cull", [True, False])
def test_twin_ray_chunking_is_invisible(cases, monkeypatch, cull):
    _, port_p, start, d = cases["robot1024"]
    whole = _port(cs.sweep_select_reference, port_p, start, d, cull=cull)
    monkeypatch.setattr(cs, "_REFERENCE_CHUNK_R", 256)
    chunked = _port(cs.sweep_select_reference, port_p, start, d, cull=cull)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a, b)


def test_pad_and_miss_rays(sphere):
    """67 rays (padded to 128; tests/test_pallas_sweep.py:108-128): aimed
    rays hit, -x rays all miss, and the twin agrees with the kernel."""
    ref_p, port_p = sphere
    rng = np.random.default_rng(5)
    n = 67
    start = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    start[:, 0] -= 3.0
    d = np.tile(np.array([-1.0, 0.0, 0.0], np.float32), (n, 1))
    t = rng.normal(size=(32, 3)).astype(np.float32) * 0.4 - start[:32]
    d[:32] = t / np.linalg.norm(t, axis=-1, keepdims=True)
    got = _port(cs.sweep_select_reference, port_p, start, d)
    ref = jax_ps.sweep_select_pallas(ref_p, start, d, interpret=True)
    assert got[0].shape == (n,)
    assert got[0][:32].sum() >= 16
    assert not got[0][32:].any()
    assert (got[1][got[0]] < port_p.num_patches).all()
    _assert_winners_agree(got, ref)


def test_tie_goes_to_lowest_patch_id(sphere):
    """Two rays hit two patches at bit-equal distance: a copy of the hit
    patch is prepended as patch 0, so the original (now w + 1) and its copy
    tie exactly.  The lowest id (0) must win, in the port and in both JAX
    paths."""
    ref_p, port_p = sphere
    start = np.array([[-3.0, 0.01, 0.02], [-3.0, -0.02, 0.01]], np.float32)
    d = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (2, 1))
    hit, w, _ = _port(cs.sweep_select_reference, port_p, start, d)
    assert hit.all() and w[0] == w[1]
    leaves = _numpy_leaves(ref_p)
    tied = {k: np.concatenate([v[w[0]:w[0] + 1], v]) for k, v in leaves.items()}
    tied["neighbours"] = np.concatenate(
        [leaves["neighbours"][w[0]:w[0] + 1], leaves["neighbours"]]) + 1
    tied_port = patches_from_numpy(tied, device="cpu")
    tied_jax = type(ref_p)(**{k: np.asarray(v) for k, v in tied.items()})
    for cull in (True, False):
        any_hit, win, dist = _port(cs.sweep_select_reference, tied_port, start, d,
                                   cull=cull)
        assert any_hit.all() and (win == 0).all(), (cull, win)
    code, dist = jax_ix.sweep_codes_xla(tied_jax, start, d)
    for ref in (jax_ps.sweep_select_pallas(tied_jax, start, d, interpret=True),
                jax_ix.select_candidates(code, dist, tied_jax.neighbours)):
        assert np.asarray(ref[0]).all() and (np.asarray(ref[1]) == 0).all()
    # the copy and the original give bit-equal distances
    code, dist = _port(ix.sweep_codes, tied_port, start, d)
    np.testing.assert_array_equal(dist[:, 0], dist[:, w[0] + 1])


_STRICT_SCRIPT = r"""
import os
os.environ["CBTR_NATIVE"] = "0"
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
# strict upstream semantics in both packages, set before any trace
from cbtr_tpu.config import DEFAULT as JCFG
from cbtr_tpu_torch.config import DEFAULT as PCFG
object.__setattr__(JCFG, "clamp_secant_estimate", False)
object.__setattr__(PCFG, "clamp_secant_estimate", False)
import torch
torch.set_num_threads(2)
from cbtr_tpu.models import scenes
from cbtr_tpu.ops import pallas_sweep as ps
from cbtr_tpu_torch.convert import patches_from_numpy
from cbtr_tpu_torch.ops import cuda_sweep as cs

scene = scenes.robot_lens_scene(res=32)
s, d = np.asarray(scene.start), np.asarray(scene.direction)
ref = [np.asarray(x) for x in ps.sweep_select_pallas(scene.patches, s, d, interpret=True)]
port = patches_from_numpy({k: np.asarray(v) for k, v in scene.patches._asdict().items()}, device="cpu")
got = [x.numpy() for x in cs.sweep_select_reference(port, torch.as_tensor(s), torch.as_tensor(d))]
assert np.mean(got[0] == ref[0]) >= 0.999
both = got[0] & ref[0]
assert both.sum() >= 100, both.sum()
np.testing.assert_array_equal(got[1][both], ref[1][both])
np.testing.assert_allclose(got[2][both], ref[2][both], rtol=1e-4, atol=1e-4)
print("STRICT_OK", int(both.sum()))
"""


def test_strict_unclamped_secant_subprocess():
    """clamp_secant_estimate=False (strict upstream semantics) in a fresh
    process, as tests/test_parity_refraction.py pins it for the JAX side."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _STRICT_SCRIPT],
                          capture_output=True, text=True, timeout=400,
                          cwd=repo, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "STRICT_OK" in proc.stdout

"""`intersect_rays` of the port against the JAX package's XLA path.

Same patches (the JAX package's, handed over as NumPy) and the same rays on
both sides.  On CPU tensors the port's winner search is the kernel's plain
twin (culled); the JAX side runs `intersect_rays(backend="xla")`.

Bar: `what` equal on >= 99.9% of rays (bench.py:174), the winning patch
equal where both hit, distance / point / normal / bary / cos_incidence
allclose rtol/atol 1e-4 (the same Newton arithmetic, a few f32 sums
associated differently).  That bar holds against the reference run op by
op (`jax.disable_jit()`).  Jitted XLA code on the CPU rounds differently,
and some robot rays end the four fixed Newton iterations unconverged (in
float64, 8 iterations instead of 4 move their normal by 1e-3 to 1), where
the rounding moves the end point: against the jitted reference, up to 14
of 172 hit rays exceed 1e-4 in normal or bary (max 1.1e-2 and 2.2e-2), up
to 10 in cos_incidence, up to 3 in point, none in distance (the counts move
with the number of CPU threads).  That comparison is held to "at most 10% of
hit rays beyond 1e-4 in the surface fields, none beyond 2.5e-2".
"""
import jax
import numpy as np
import pytest
import torch

from cbtr_tpu.bezier import build_from_trimesh as jax_build
from cbtr_tpu.harness.measure import preprocess as jax_preprocess
from cbtr_tpu.mesh.core import make_unit_sphere as jax_sphere
from cbtr_tpu.models import scenes as jax_scenes
from cbtr_tpu.ops.intersect import intersect_rays as jax_intersect

from cbtr_tpu_torch.convert import patches_from_numpy
from cbtr_tpu_torch.ops import cuda_sweep as cs
from cbtr_tpu_torch.ops import intersect as ix

torch.set_num_threads(2)


def _fan(n, seed):
    rng = np.random.default_rng(seed)
    start = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    start[:, 0] -= 3.0
    target = rng.normal(size=(n, 3)).astype(np.float32) * 0.4
    d = target - start
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return start, d


def _to_port(patches):
    return patches_from_numpy({k: np.asarray(v) for k, v in patches._asdict().items()}, device="cpu")


@pytest.fixture(scope="module")
def cases():
    sphere = jax_build(jax_preprocess(jax_sphere(7, 3), use_native=False))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CBTR_NATIVE", "0")
        robot = jax_scenes.robot_lens_scene(res=32)
    return {
        "sphere1024": (sphere, _to_port(sphere)) + _fan(1024, 3),
        "robot1024": (robot.patches, _to_port(robot.patches),
                      np.asarray(robot.start), np.asarray(robot.direction)),
    }


@pytest.mark.parametrize("case,jit,loose_frac", [
    ("sphere1024", False, 0.0), ("robot1024", False, 0.0), ("robot1024", True, 0.1)])
def test_intersect_rays_matches_jax(cases, case, jit, loose_frac):
    ref_p, port_p, start, d = cases[case]
    if jit:
        ref = jax_intersect(ref_p, start, d, backend="xla")
    else:
        with jax.disable_jit():
            ref = jax_intersect(ref_p, start, d, backend="xla")
    got = ix.intersect_rays(port_p, torch.tensor(start), torch.tensor(d))
    what_r, what_p = np.asarray(ref.what), got.what.numpy()
    assert np.mean(what_r == what_p) >= 0.999
    both = (what_r == ix.WHAT_INTERSECT) & (what_p == ix.WHAT_INTERSECT)
    assert both.sum() >= 100
    np.testing.assert_array_equal(got.patch.numpy()[both], np.asarray(ref.patch)[both])
    for field in ("distance", "point", "normal", "bary", "cos_incidence"):
        a = getattr(got, field).detach().numpy()[both]
        b = np.asarray(getattr(ref, field))[both]
        close = np.isclose(a, b, rtol=1e-4, atol=1e-4)
        loose = ~close.reshape(close.shape[0], -1).all(axis=-1)
        assert loose.mean() <= (0.0 if field == "distance" else loose_frac), (
            field, np.nonzero(loose)[0])
        np.testing.assert_allclose(a, b, rtol=0, atol=2.5e-2, err_msg=field)


@pytest.mark.parametrize("case", ["sphere1024", "robot1024"])
def test_recompute_reject_count_is_zero(cases, case):
    """The sweep's winners re-evaluate as accepted hits: the twin and the
    recompute share one candidate function."""
    _, port_p, start, d = cases[case]
    s, dd = torch.tensor(start), torch.tensor(d)
    any_hit, win, _ = cs.sweep_select_reference(port_p, s, dd)
    hit, rejects = ix.recompute_winner(port_p, s, dd, any_hit, win, with_check=True)
    assert any_hit.sum() >= 100
    assert rejects == 0
    assert (hit.patch[any_hit] == win[any_hit]).all()


def test_chunked_intersect_matches_unchunked(cases):
    """chunk_size scans the rays with the recompute checkpointed: the same
    hits, and the same control-point gradient."""
    _, port_p, start, d = cases["robot1024"]
    cp = port_p.control_points.clone().requires_grad_(True)
    patches = port_p.replace(control_points=cp)
    s, dd = torch.tensor(start), torch.tensor(d)
    grads, hits = [], []
    for chunk in (0, 300):
        hit = ix.intersect_rays(patches, s, dd, chunk_size=chunk)
        (g,) = torch.autograd.grad(
            (hit.point * (hit.what == ix.WHAT_INTERSECT)[:, None]).sum(), cp)
        grads.append(g)
        hits.append(hit)
    for a, b in zip(*hits):
        assert torch.equal(a, b)
    assert grads[0].abs().max() > 0
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-7)


def test_backends_and_batch_shape(cases):
    _, port_p, start, d = cases["sphere1024"]
    s, dd = torch.tensor(start), torch.tensor(d)
    flat = ix.intersect_rays(port_p, s, dd)
    plain = ix.intersect_rays(port_p, s, dd, backend="plain")
    batched = ix.intersect_rays(port_p, s.reshape(4, 256, 3), dd.reshape(4, 256, 3))
    for a, b, c in zip(flat, plain, batched):
        assert torch.equal(a, b)
        assert c.shape[:2] == (4, 256)
        assert torch.equal(a, c.reshape(a.shape))
    with pytest.raises(ValueError):
        ix.intersect_rays(port_p, s, dd, backend="pallas")

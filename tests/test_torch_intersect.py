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
from cbtr_tpu.ops import intersect as jix
from cbtr_tpu.ops.intersect import intersect_rays as jax_intersect

from cbtr_tpu_torch.bezier import build_from_trimesh
from cbtr_tpu_torch.convert import patches_from_numpy
from cbtr_tpu_torch.harness import preprocess
from cbtr_tpu_torch.mesh.core import make_unit_sphere
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


# ---------------------------------------------------------------------------
# the dense debug path (tests/test_intersect.py:242-270)
# ---------------------------------------------------------------------------

CENTER = np.array([5.0, 0.0, 0.0], np.float32)


def _dense_rays():
    """tests/test_intersect.py's 96 rays engineered to include seam and edge
    hits (off-axis, varied origins)."""
    rng = np.random.default_rng(21)
    n = 96
    start = rng.normal(size=(n, 3)).astype(np.float32) * 0.2
    target = CENTER + rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    d = target - start
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return start, d.astype(np.float32)


@pytest.fixture(scope="module")
def dense_sphere():
    """The sphere 15 x 7 at CENTER, built by each package (both preprocess
    on the native runtime by default)."""
    mesh = preprocess(make_unit_sphere(15, 7))
    mesh.translate(CENTER)
    jax_mesh = jax_preprocess(jax_sphere(15, 7))
    jax_mesh.translate(CENTER)
    return build_from_trimesh(preprocess(mesh), device="cpu"), jax_build(jax_preprocess(jax_mesh))


def test_dense_retry_path_matches_production_pipeline(dense_sphere):
    """`candidates_with_retry` + `select_best` (the dense formulation of the
    follow-side retry, reference/bezierMesh.cpp:213-217) give the same
    RayHit as the sweep -> select -> recompute pipeline (here K1's plain
    twin), with tests/test_intersect.py's bars."""
    patches, _ = dense_sphere
    start, d = _dense_rays()
    s, dd = torch.tensor(start), torch.tensor(d)
    prod = ix._intersect_chunk(patches, s, dd, backend="plain")
    dense = ix.select_best(*ix.candidates_with_retry(patches, patches, 0, s, dd))

    assert torch.equal(prod.what, dense.what)
    hit = prod.what == ix.WHAT_INTERSECT
    assert int(hit.sum()) >= 48, "fixture too weak"
    assert torch.equal(prod.patch[hit], dense.patch[hit])
    torch.testing.assert_close(prod.distance[hit], dense.distance[hit], rtol=1e-6, atol=1e-6)
    for a, b in ((prod.point, dense.point), (prod.normal, dense.normal),
                 (prod.bary, dense.bary)):
        torch.testing.assert_close(a[hit], b[hit], rtol=1e-5, atol=1e-5)


def test_dense_retry_path_matches_jax(dense_sphere):
    """On the JAX package's patch tables and the same rays, the port's
    `candidates_with_retry` against the JAX function pair by pair (codes
    and retry targets equal on every pair, the floats of every pair with an
    accepted candidate within 1e-4), and `select_best` against the JAX
    `select_best` ray by ray."""
    _, ref_p = dense_sphere
    port_p = _to_port(ref_p)
    start, d = _dense_rays()
    got = ix.candidates_with_retry(port_p, port_p, 0, torch.tensor(start), torch.tensor(d))
    with jax.disable_jit():
        want = jix.candidates_with_retry(ref_p, ref_p, 0, start, d)
    what_g, what_w = got[0].numpy(), np.asarray(want[0])
    np.testing.assert_array_equal(what_g, what_w)
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(want[6]))
    accepted = what_w == ix.WHAT_INTERSECT
    assert accepted.sum() >= 48
    for g, w in zip(got[1:6], want[1:6]):
        np.testing.assert_allclose(g.numpy()[accepted], np.asarray(w)[accepted],
                                   rtol=1e-4, atol=1e-4)
    best_g = ix.select_best(*got)
    with jax.disable_jit():
        best_w = jix.select_best(*want)
    np.testing.assert_array_equal(best_g.what.numpy(), np.asarray(best_w.what))
    np.testing.assert_array_equal(best_g.patch.numpy(), np.asarray(best_w.patch))


def test_dense_retry_path_sharded_over_patches(dense_sphere):
    """The dense path over two halves of the table (each half scans its own
    rows, the retry gathers from the whole table by global id), the halves'
    candidates side by side: the same RayHit as over the whole table."""
    patches, _ = dense_sphere
    start, d = _dense_rays()
    s, dd = torch.tensor(start), torch.tensor(d)
    P = patches.num_patches
    half = P // 2
    parts = [ix.candidates_with_retry(patches.row(torch.arange(lo, hi)), patches, lo, s, dd)
             for lo, hi in ((0, half), (half, P))]
    sharded = ix.select_best(*(torch.cat(f, dim=1) for f in zip(*parts)))
    whole = ix.select_best(*ix.candidates_with_retry(patches, patches, 0, s, dd))
    for a, b in zip(sharded, whole):
        assert torch.equal(a, b)
    assert int((whole.what == ix.WHAT_INTERSECT).sum()) >= 48


def test_patches_row_gathers_every_leaf(dense_sphere):
    patches, _ = dense_sphere
    idx = torch.tensor([[3, 0], [7, 7]])
    rows = patches.row(idx)
    for name, leaf in patches.leaves().items():
        got = getattr(rows, name)
        assert got.shape == (2, 2) + leaf.shape[1:], name
        assert torch.equal(got[1, 0], leaf[7]) and torch.equal(got[0, 1], leaf[0]), name

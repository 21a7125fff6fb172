"""The (tile x block) cull that K1, K2 (block 16) and K3 (block 32) run
inside the kernel, on the CPU.

`block_bounds` is the one [B, 12] table every cull reads; `tile_block_lists`
(the plain twins' lists) is built on it and is held against the
JAX package's list builder; `tile_bitmap_reference` is the kernels' own
cull, one (ray, block) at a time in csrc/block_walk.cuh's order, and must
give the same [T, B] bitmap as the lists.  The lenses are the port's own
CPU builds (robot, refined robot, sphere); the JAX functions get the same
control points as NumPy arrays.

Tolerances: block centres are bit-equal to `_block_spheres_cr`'s when both
start from the JAX package's per-patch spheres.  Radii and AABB corners
differ in the last bits (at most a few ulps of the larger coordinate): the
port sums |v|^2 = x*x + y*y + z*z left to right, `jnp.linalg.norm` in
XLA's reduction order.  The lists, which are what the bounds decide, are
equal exactly.
"""
import inspect
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbtr_tpu.ops import pallas_sweep as jax_ps

from cbtr_tpu_torch.harness import profile_step
from cbtr_tpu_torch.models import fit, scenes
from cbtr_tpu_torch.ops import cuda_sweep as cs
from cbtr_tpu_torch.ops import cuda_winner as cw

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cases():
    """name -> (port patches, the same control points for JAX, the scene's
    collimated rays: start, d)."""
    out = {}
    robot = scenes.robot_lens_scene(res=32, device="cpu")
    refined = scenes.robot_lens_scene(res=16, refine=True, device="cpu")
    sphere = scenes.sphere_lens_scene(res=32, device="cpu")
    for name, sc in (("robot", robot), ("refined", refined), ("sphere", sphere)):
        patches, start, d = sc.patches, sc.start.numpy(), sc.direction.numpy()
        ref = types.SimpleNamespace(control_points=jnp.asarray(patches.control_points.numpy()),
                                    num_patches=patches.num_patches)
        out[name] = (patches, ref, start, d)
    return out


def _rays_t(start, d):
    return cs.pad_rays(torch.as_tensor(start), torch.as_tensor(d))


@pytest.mark.parametrize("block_p", [16, 32])
@pytest.mark.parametrize("case", ["robot", "refined", "sphere"])
def test_block_bounds_match_jax(cases, case, block_p):
    port, ref, _, _ = cases[case]
    center, radius = jax_ps.patch_spheres(ref)
    lo, hi = jax_ps._patch_boxes(ref.control_points, center, radius)
    pad = (-ref.num_patches) % 128

    def padded(x):
        return jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))

    c, r = jax_ps._block_spheres_cr(padded(center), padded(radius), block_p)
    real = (padded(radius) > 0.0).reshape(-1, block_p)[..., None]
    lob = jnp.min(jnp.where(real, padded(lo).reshape(-1, block_p, 3), jnp.inf), axis=1)
    hib = jnp.max(jnp.where(real, padded(hi).reshape(-1, block_p, 3), -jnp.inf), axis=1)
    spheres = (torch.tensor(np.asarray(center)), torch.tensor(np.asarray(radius)))
    got = cs.block_bounds(port, block_p, spheres).numpy()
    assert got.shape == ((ref.num_patches + pad) // block_p, 12) and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, 0:3], np.asarray(c))
    np.testing.assert_allclose(got[:, 3], np.asarray(r), rtol=1e-6, atol=0)
    for cols, want in ((slice(4, 7), lob), (slice(7, 10), hib)):
        want = np.asarray(want)
        finite = np.isfinite(want)
        np.testing.assert_array_equal(got[:, cols][~finite], want[~finite])
        np.testing.assert_allclose(got[:, cols][finite], want[finite], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:, 10:], 0.0)
    # all-padding blocks: radius -1, empty boxes
    empty = np.asarray(r) < 0
    assert (got[empty, 3] == -1.0).all() and np.isposinf(got[empty, 4:7]).all()
    # the port's own spheres are the default
    np.testing.assert_array_equal(cs.block_bounds(port, block_p).numpy(),
                                  cs.block_bounds(port, block_p, cs.patch_spheres(port)).numpy())


@pytest.mark.parametrize("use_aabb", [False, True])
@pytest.mark.parametrize("block_p", [16, 32])
def test_refined_lists_match_jax(cases, block_p, use_aabb):
    """The rebuilt `tile_block_lists` on the refined robot (K2's lens),
    against the JAX list builder at both block sizes, with and without the
    AABB leg (the sphere and robot fans: test_torch_sweep_codes.py)."""
    port, ref, start, d = cases["refined"]
    rays_t = _rays_t(start, d)
    counts, lists = cs.tile_block_lists(port, rays_t, block_p, use_aabb)
    c_ref, l_ref = jax_ps.tile_block_lists(ref, rays_t.numpy(), 128, block_p, use_aabb)
    assert counts.sum() > 0
    np.testing.assert_array_equal(counts.numpy(), np.asarray(c_ref))
    np.testing.assert_array_equal(lists.numpy(), np.asarray(l_ref))


@pytest.mark.parametrize("use_aabb", [False, True])
@pytest.mark.parametrize("case", ["robot", "refined", "sphere"])
def test_tile_bitmap_reference_equals_lists(cases, case, use_aabb):
    """The kernels' cull (plain version) lists exactly the blocks of
    `tile_block_lists`."""
    port, _, start, d = cases[case]
    rays_t = _rays_t(start, d)
    P_pad = cs.pack_patch_table(port).shape[0]
    want = cs.listed_blocks(*cs.tile_block_lists(port, rays_t, use_aabb=use_aabb), P_pad)
    got = cs.tile_bitmap_reference(cs.block_bounds(port), rays_t, use_aabb)
    assert got.shape == want.shape == (rays_t.shape[1] // cs.TILE_R, P_pad // cs.BLOCK_P)
    assert want.any() and not want.all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("use_aabb", [False, True])
@pytest.mark.parametrize("case", ["robot", "sphere"])
def test_tile_bitmap_reference_equals_lists_at_block_32(cases, case, use_aabb):
    """K3's cull (block 32, inside the kernel): its plain version over
    `block_bounds(p, 32)` lists exactly the blocks of
    `tile_block_lists(block_p=32)`, and both equal the JAX package's lists
    at block 32."""
    port, ref, start, d = cases[case]
    rays_t = _rays_t(start, d)
    P_pad = cs.pack_patch_table(port).shape[0]
    counts, lists = cs.tile_block_lists(port, rays_t, 32, use_aabb)
    want = cs.listed_blocks(counts, lists, P_pad, 32)
    got = cs.tile_bitmap_reference(cs.block_bounds(port, 32), rays_t, use_aabb)
    assert got.shape == want.shape == (rays_t.shape[1] // cs.TILE_R, P_pad // 32)
    assert want.any() and not want.all()
    assert torch.equal(got, want)
    c_ref, l_ref = jax_ps.tile_block_lists(ref, rays_t.numpy(), 128, 32, use_aabb)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(c_ref))
    np.testing.assert_array_equal(lists.numpy(), np.asarray(l_ref))


def test_tile_bitmap_reference_on_axis_parallel_rays(cases):
    """Rays with direction components exactly 0 (the slab test's +-1e-30
    substitution), one 128-ray tile per axis and sign, through the lens
    and beside it: the bitmap equals the lists, the port's and the JAX
    package's."""
    port, ref, _, _ = cases["robot"]
    rng = np.random.default_rng(11)
    starts, dirs = [], []
    for axis in range(3):
        for sign in (1.0, -1.0):
            d = np.zeros((128, 3), np.float32)
            d[:, axis] = sign
            s = rng.uniform(-1.2, 1.2, size=(128, 3)).astype(np.float32)
            s[:, 0] += 5.0
            s[:, axis] = (5.0 if axis == 0 else 0.0) - 3.0 * sign
            starts.append(s)
            dirs.append(d)
    rays_t = _rays_t(np.concatenate(starts), np.concatenate(dirs))
    assert (rays_t[3:6] == 0.0).sum() == 2 * rays_t.shape[1]
    bounds = cs.block_bounds(port)
    P_pad = cs.pack_patch_table(port).shape[0]
    for use_aabb in (False, True):
        counts, lists = cs.tile_block_lists(port, rays_t, use_aabb=use_aabb)
        c_ref, l_ref = jax_ps.tile_block_lists(ref, rays_t.numpy(), 128, cs.BLOCK_P, use_aabb)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(c_ref))
        np.testing.assert_array_equal(lists.numpy(), np.asarray(l_ref))
        got = cs.tile_bitmap_reference(bounds, rays_t, use_aabb)
        assert torch.equal(got, cs.listed_blocks(counts, lists, P_pad))
        assert got.any(dim=1).all()         # every tile crosses the lens


def test_tile_bitmap_reference_chunking_is_invisible(cases, monkeypatch):
    port, _, start, d = cases["refined"]
    rays_t = _rays_t(start, d)
    bounds = cs.block_bounds(port)
    whole = cs.tile_bitmap_reference(bounds, rays_t)
    monkeypatch.setattr(cs, "_LIST_CHUNK_PAIRS", 1)
    assert torch.equal(cs.tile_bitmap_reference(bounds, rays_t), whole)


@pytest.mark.parametrize("prepare", [cs.prepare_inputs, cw.prepare_inputs])
def test_prepare_inputs_builds_no_lists(cases, prepare, monkeypatch):
    """The kernels' tables: rays, patch table, bounds, neighbours; the list
    builder is never called."""
    port, _, start, d = cases["robot"]
    called = []
    monkeypatch.setattr(cs, "tile_block_lists", lambda *a, **k: called.append(a))
    inputs = prepare(port, torch.as_tensor(start), torch.as_tensor(d), use_aabb=False)
    assert called == [] and inputs.use_aabb is False
    assert not hasattr(inputs, "counts") and not hasattr(inputs, "lists")
    assert torch.equal(inputs.bounds, cs.block_bounds(port))
    assert torch.equal(inputs.patch_t, cs.pack_patch_table(port))
    assert inputs.nb.dtype == torch.int32 and inputs.nb.shape == (512, 3)


def _replace(inputs, **fields):
    import dataclasses
    return dataclasses.replace(inputs, **fields)


@pytest.mark.parametrize("fault, match", [
    (lambda i: {}, "CUDA"),
    (lambda i: {"bounds": i.bounds[:-1]}, "bounds"),
    (lambda i: {"bounds": i.bounds.double()}, "bounds"),
    (lambda i: {"bounds": i.bounds.T.contiguous().T}, "bounds"),
    (lambda i: {"patch_t": i.patch_t[:, :60].contiguous()}, "patch_t"),
    (lambda i: {"nb": i.nb.long()}, "neighbours"),
    (lambda i: {"rays_t": i.rays_t[:, :100].contiguous()}, "unsupported shape"),
    (lambda i: {"num_patches": 0}, "unsupported shape"),
    (lambda i: {"boxes": i.boxes[:, :6].contiguous()}, "boxes"),
    (lambda i: {"boxes": i.boxes.double()}, "boxes"),
])
def test_check_inputs_refuses(cases, fault, match):
    """CPU tables and tables of the wrong shape, type or layout never reach
    a kernel (the shape checks come first, so they show on the CPU too)."""
    port, _, start, d = cases["robot"]
    inputs = cs.prepare_inputs(port, torch.as_tensor(start[:200]), torch.as_tensor(d[:200]))
    with pytest.raises(ValueError, match=match):
        cs.check_inputs(_replace(inputs, **fault(inputs)), "K1")


def test_profile_step_without_a_card_raises(monkeypatch):
    """The profiler runs on the card; without one it names the device and
    stops, before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        profile_step.run_profile(res=16, runs=1)
    with pytest.raises(RuntimeError, match="cuda"):
        profile_step.main(["--res", "16", "--runs", "1"])


@pytest.mark.parametrize("fn", [scenes.sphere_lens_scene, scenes.ellipsoid_lens_scene,
                                scenes.dimpled_lens_scene, scenes.robot_lens_scene,
                                fit.emitter_rays, profile_step.run_profile])
def test_entry_points_default_to_the_card(fn):
    """No entry point runs on the CPU unless the caller asks for it."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_default_device_without_a_card_raises():
    """Where there is no card, the default device fails instead of falling
    back to the CPU (decided here, not at import)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises((RuntimeError, AssertionError)):
        fit.emitter_rays(8)
    with pytest.raises((RuntimeError, AssertionError)):
        scenes.sphere_lens_scene(res=4)

"""The table kernel (csrc/tables.cu, ops/cuda_tables.py) on the CPU: its
plain version against the JAX package, the order of its arithmetic, K3's
tables, and the entry points that now default to the card.

* `build_tables` on CPU tensors runs the plain versions and is held against
  the JAX package's `pack_patch_table`, `block_spheres` and `_patch_boxes`
  on the same NumPy patches.  Bars: the 60 copied columns bit-equal; sphere
  centres, block centres and box corners within atol 1e-6, radii within
  rtol 1e-6 + atol 1e-6 (the port sums x*x + y*y + z*z and the ten control
  points left to right, XLA in its reduction order: a few ulps of the
  coordinates, which are about 5, and the radii inherit the centres').
* `_scalar_tables` is the kernel's arithmetic one row and one block at a
  time in NumPy f32 scalars, in the order csrc/tables.cu follows; it must
  be bit-equal to the plain versions, which pins that order.  The square
  root there is the correctly rounded one, as on the card; torch's CPU
  square root is not always (see `_norm3_rounded`).
* The kernel itself needs nvcc and a card: chip_smoke.py holds it
  `torch.equal` to the plain versions there.
"""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

from cbtr_tpu.bezier import build_from_trimesh as jax_build
from cbtr_tpu.harness.measure import preprocess as jax_preprocess
from cbtr_tpu.mesh.core import make_unit_sphere as jax_sphere
from cbtr_tpu.models import scenes as jax_scenes
from cbtr_tpu.ops import pallas_sweep as jax_ps

from cbtr_tpu_torch.bezier import build_from_trimesh
from cbtr_tpu_torch.convert import patches_from_numpy
from cbtr_tpu_torch.harness import preprocess
from cbtr_tpu_torch.harness.measure import measure_approximation
from cbtr_tpu_torch.mesh.core import make_unit_sphere
from cbtr_tpu_torch.models import scenes
from cbtr_tpu_torch.ops import cuda_codes as cc
from cbtr_tpu_torch.ops import cuda_lib
from cbtr_tpu_torch.ops import cuda_sweep as cs
from cbtr_tpu_torch.ops import cuda_tables as ct
from cbtr_tpu_torch.ops import cuda_winner as cw

torch.set_num_threads(2)

f32 = np.float32


@pytest.fixture(scope="module")
def jax_cases():
    """name -> (JAX patches, the port's patches from the same NumPy leaves)."""
    sphere = jax_build(jax_preprocess(jax_sphere(7, 3), use_native=False))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CBTR_NATIVE", "0")
        robot = jax_scenes.robot_lens_scene(res=4).patches
    return {name: (ref, patches_from_numpy(
        {k: np.asarray(v) for k, v in ref._asdict().items()}, device="cpu"))
        for name, ref in (("sphere", sphere), ("robot", robot))}


@pytest.fixture(scope="module")
def port_cases():
    """The port's own CPU builds: the sphere 7 x 3 and the robot."""
    return {"sphere": build_from_trimesh(preprocess(make_unit_sphere(7, 3)), device="cpu"),
            "robot": scenes.robot_lens_scene(res=4, device="cpu").patches}


# ---------------------------------------------------------------------------
# (c) the plain version against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_p", [16, 32])
@pytest.mark.parametrize("case", ["sphere", "robot"])
def test_build_tables_on_cpu_matches_jax(jax_cases, case, block_p):
    ref, port = jax_cases[case]
    P = ref.num_patches
    before = cuda_lib.launch_counts()["tables"]
    patch_t, bounds, nb = (x.numpy() for x in ct.build_tables(port, block_p))
    assert cuda_lib.launch_counts()["tables"] == before and "tables" not in cuda_lib.loaded()
    P_pad = P + (-P) % 128
    assert patch_t.shape == (P_pad, 64) and patch_t.dtype == np.float32
    assert bounds.shape == (P_pad // block_p, 12) and bounds.dtype == np.float32
    assert nb.shape == (P_pad, 3) and nb.dtype == np.int32

    want_t = np.asarray(jax_ps.pack_patch_table(ref, 128))
    np.testing.assert_array_equal(patch_t[:, :60], want_t[:, :60])
    np.testing.assert_allclose(patch_t[:, 60:63], want_t[:, 60:63], rtol=0, atol=1e-6)
    np.testing.assert_allclose(patch_t[:, 63], want_t[:, 63], rtol=1e-6, atol=1e-6)
    assert (patch_t[P:] == 0.0).all()
    np.testing.assert_array_equal(nb[:P], np.asarray(ref.neighbours))
    assert (nb[P:] == -1).all()

    c, r = (np.asarray(x) for x in jax_ps.block_spheres(ref, 128, block_p))
    np.testing.assert_allclose(bounds[:, 0:3], c, rtol=0, atol=1e-6)
    np.testing.assert_allclose(bounds[:, 3], r, rtol=1e-6, atol=1e-6)
    center, radius = jax_ps.patch_spheres(ref)
    lo, hi = (np.pad(np.asarray(x), ((0, P_pad - P), (0, 0))).reshape(-1, block_p, 3)
              for x in jax_ps._patch_boxes(ref.control_points, center, radius))
    real = (np.arange(P_pad) < P).reshape(-1, block_p, 1)
    lob = np.where(real, lo, np.inf).min(axis=1)
    hib = np.where(real, hi, -np.inf).max(axis=1)
    empty = ~real.any(axis=(1, 2))
    assert empty.any() == (case == "robot") and (bounds[empty, 3] == -1.0).all()
    np.testing.assert_array_equal(bounds[empty, 4:10], np.concatenate([lob, hib], 1)[empty])
    np.testing.assert_allclose(bounds[~empty, 4:7], lob[~empty], rtol=0, atol=1e-6)
    np.testing.assert_allclose(bounds[~empty, 7:10], hib[~empty], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(bounds[:, 10:], 0.0)


# ---------------------------------------------------------------------------
# (b) the kernel's arithmetic, one row and one block at a time
# ---------------------------------------------------------------------------

def _norm3(x, y, z):
    return np.sqrt(x * x + y * y + z * z)


def _scalar_tables(leaves, block_p):
    """csrc/tables.cu in NumPy f32 scalars: a loop over the padded rows, then
    a loop over the blocks, each expression in the kernel's order."""
    cp = leaves["control_points"].reshape(-1, 30)
    P = cp.shape[0]
    P_pad = P + (-P) % 128
    patch_t = np.zeros((P_pad, 64), f32)
    nb = np.full((P_pad, 3), -1, np.int32)
    lo, hi = np.zeros((P_pad, 3), f32), np.zeros((P_pad, 3), f32)
    for p in range(P):
        row = patch_t[p]
        row[0:30] = cp[p]
        row[30:34] = leaves["underlying"][p]
        row[34:43] = leaves["bary_inverse"][p].reshape(9)
        row[43:45] = leaves["heights"][p]
        row[45:48] = leaves["deriv_b"][p]
        row[48:60] = leaves["dividers"][p].reshape(12)
        nb[p] = leaves["neighbours"][p]
        c = []
        for x in range(3):
            total = row[x]
            for k in range(1, 10):
                total = total + row[3 * k + x]
            c.append(total / f32(10.0))
        r_hull = _norm3(row[0] - c[0], row[1] - c[1], row[2] - c[2])
        for k in range(1, 10):
            r_hull = np.maximum(r_hull, _norm3(row[3 * k] - c[0], row[3 * k + 1] - c[1],
                                               row[3 * k + 2] - c[2]))
        radius = r_hull * f32(1.25) + f32(1e-5)
        slack = np.maximum(radius - r_hull, f32(0.0))
        for x in range(3):
            mn = mx = row[x]
            for k in range(1, 10):
                mn, mx = np.minimum(mn, row[3 * k + x]), np.maximum(mx, row[3 * k + x])
            lo[p, x], hi[p, x] = mn - slack, mx + slack
            row[60 + x] = c[x]
        row[63] = radius
    assert all(isinstance(v, f32) for v in (radius, slack, r_hull, c[0]))

    bounds = np.zeros((P_pad // block_p, 12), f32)
    for b in range(P_pad // block_p):
        rows = range(b * block_p, (b + 1) * block_p)
        real = [patch_t[i, 63] > 0.0 for i in rows]
        denom = f32(max(sum(real), 1))
        c = []
        for x in range(3):
            total = patch_t[rows[0], 60 + x] if real[0] else f32(0.0)
            for i, is_real in zip(rows[1:], real[1:]):
                total = total + (patch_t[i, 60 + x] if is_real else f32(0.0))
            c.append(total / denom)
        radius = f32(-1.0)
        blo, bhi = [f32(np.inf)] * 3, [f32(-np.inf)] * 3
        for i, is_real in zip(rows, real):
            if not is_real:
                continue
            reach = _norm3(patch_t[i, 60] - c[0], patch_t[i, 61] - c[1],
                           patch_t[i, 62] - c[2]) + patch_t[i, 63]
            radius = np.maximum(radius, reach)
            for x in range(3):
                blo[x], bhi[x] = np.minimum(blo[x], lo[i, x]), np.maximum(bhi[x], hi[i, x])
        bounds[b, 0:3], bounds[b, 3], bounds[b, 4:7], bounds[b, 7:10] = c, radius, blo, bhi
    return patch_t, bounds, nb


def _norm3_rounded(v):
    """`cuda_sweep._norm3` with the correctly rounded f32 square root (through
    f64), which is what the card's sqrt.rn.f32, torch's CUDA sqrt and NumPy
    give.  torch's vectorised CPU sqrt is within 0.5 ulp but not always that
    value (1 ulp off on about 0.6 % of inputs: 5 of the robot's 450 radii)."""
    n2 = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]
    return torch.sqrt(n2.double()).to(n2.dtype)


@pytest.mark.parametrize("case", ["sphere", "robot"])
def test_scalar_order_is_bit_equal_to_the_plain_versions(port_cases, case, monkeypatch):
    """The order csrc/tables.cu follows gives the plain versions' bits:
    patch table, neighbours, bounds at block 16 and 32 (with the square root
    rounded as on the card, `_norm3_rounded`; with torch's CPU square root
    the radii and what follows from them are within 1e-6)."""
    port = port_cases[case]
    leaves = {k: v.numpy() for k, v in port.leaves().items()}
    for block_p in (16, 32):
        patch_t, bounds, nb = _scalar_tables(leaves, block_p)
        want_t, want_b, _ = (x.numpy() for x in ct.build_tables_reference(port, block_p))
        np.testing.assert_allclose(patch_t, want_t, rtol=1e-6, atol=1e-6)
        finite = np.isfinite(want_b)
        np.testing.assert_array_equal(bounds[~finite], want_b[~finite])
        np.testing.assert_allclose(bounds[finite], want_b[finite], rtol=1e-6, atol=1e-6)
    monkeypatch.setattr(cs, "_norm3", _norm3_rounded)
    for block_p in (16, 32):
        patch_t, bounds, nb = _scalar_tables(leaves, block_p)
        assert patch_t.dtype == bounds.dtype == np.float32
        np.testing.assert_array_equal(patch_t, cs.pack_patch_table(port).numpy())
        np.testing.assert_array_equal(bounds, cs.block_bounds(port, block_p).numpy())
        want = ct.build_tables_reference(port, block_p)
        for got, w in zip((patch_t, bounds, nb), want):
            np.testing.assert_array_equal(got, w.numpy())
        # the robot's padding holds whole blocks, the sphere's (126 of 128) none
        assert (bounds[:, 3] == -1.0).any() == (case == "robot") and (bounds[:, 3] > 0).any()


def test_scalar_order_tells_another_order_apart(port_cases):
    """The check above is not vacuous: a centre computed as sum * (1/10)
    instead of sum / 10 changes bits of the robot's table."""
    port = port_cases["robot"]
    cp = port.control_points
    center = cs._seq_sum(cp, 1) * 0.1
    assert not torch.equal(center, cs.patch_spheres(port)[0])


# ---------------------------------------------------------------------------
# the wrapper, and the kernels' tables through it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_p", [16, 32])
def test_build_tables_reference_is_the_plain_versions(port_cases, block_p):
    port = port_cases["robot"]
    patch_t, bounds, nb = ct.build_tables(port, block_p)
    assert torch.equal(patch_t, cs.pack_patch_table(port))
    assert torch.equal(bounds, cs.block_bounds(port, block_p))
    assert nb.dtype == torch.int32 and torch.equal(nb[:450], port.neighbours.to(torch.int32))
    assert (nb[450:] == -1).all() and nb.shape == (512, 3)


@pytest.mark.parametrize("fault, match", [
    (lambda p: (p, 16), "CUDA"),
    (lambda p: (p, 24), "block_p"),
    (lambda p: (p, 0), "block_p"),
    (lambda p: (p.map(lambda t: t.double() if t.is_floating_point() else t), 16),
     "f32"),
    (lambda p: (p.replace(heights=p.heights[:-1]), 16), "heights"),
    (lambda p: (p.replace(neighbours=p.neighbours[:, :2]), 16), "neighbours"),
])
def test_table_launch_refuses(port_cases, fault, match):
    """CPU patches, a block size that does not divide the padding, and
    leaves of another type or length never reach the kernel (no cast: the
    plain versions round f64 patches differently)."""
    patches, block_p = fault(port_cases["sphere"])
    with pytest.raises(ValueError, match=match):
        ct.launch(patches, block_p)
    assert "tables" not in cuda_lib.loaded()


def test_plain_versions_take_f64_patches(port_cases):
    """On the CPU the wrapper runs the plain versions, which compute in the
    patches' type and cast afterwards."""
    port = port_cases["sphere"]
    wide = port.map(lambda t: t.double() if t.is_floating_point() else t)
    patch_t, bounds, _ = ct.build_tables(wide, 16)
    assert patch_t.dtype == bounds.dtype == torch.float32
    torch.testing.assert_close(patch_t, cs.pack_patch_table(port), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("prepare, block_p", [(cs.prepare_inputs, 16), (cw.prepare_inputs, 16),
                                              (cc.prepare_inputs, 32)])
def test_prepare_inputs_read_build_tables(port_cases, prepare, block_p, monkeypatch):
    """K1's, K2's and K3's tables come from `build_tables` at the kernel's
    block size, and `tile_block_lists` never runs."""
    port = port_cases["robot"]
    calls = []
    build = ct.build_tables

    def counted(patches, block, **kwargs):
        calls.append(block)
        return build(patches, block, **kwargs)

    monkeypatch.setattr(ct, "build_tables", counted)
    monkeypatch.setattr(cs, "tile_block_lists", lambda *a, **k: calls.append("lists"))
    rng = np.random.default_rng(5)
    start = torch.tensor(rng.normal(size=(200, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.tensor(rng.normal(size=(200, 3)).astype(np.float32)),
                                      dim=-1)
    inputs = prepare(port, start, d, False)
    assert calls == [block_p] and inputs.use_aabb is False
    assert inputs.rays_t.shape == (8, 256) and inputs.num_patches == 450
    assert torch.equal(inputs.patch_t, cs.pack_patch_table(port))
    assert torch.equal(inputs.bounds, cs.block_bounds(port, block_p))


def _codes_inputs(port):
    rng = np.random.default_rng(6)
    start = torch.tensor(rng.normal(size=(200, 3)).astype(np.float32))
    return cc.prepare_inputs(port, start, torch.ones_like(start) / 3 ** 0.5)


def test_codes_inputs_fields(port_cases):
    inputs = _codes_inputs(port_cases["robot"])
    assert [f.name for f in dataclasses.fields(inputs)] == [
        "rays_t", "patch_t", "bounds", "num_patches", "use_aabb"]
    assert inputs.use_aabb is True and inputs.num_patches == 450
    for t, dtype, shape in ((inputs.rays_t, torch.float32, (8, 256)),
                            (inputs.patch_t, torch.float32, (512, 64)),
                            (inputs.bounds, torch.float32, (16, 12))):
        assert t.dtype == dtype and tuple(t.shape) == shape and t.is_contiguous()
    code, dist = cc.filled_outputs(inputs)
    assert code.shape == dist.shape == (512, 256)
    assert (code == 3).all() and (dist == 0.0).all()


@pytest.mark.parametrize("fault, match", [
    (lambda i, p: {}, "CUDA"),
    (lambda i, p: {"bounds": i.bounds[:-1]}, "bounds"),
    (lambda i, p: {"bounds": i.bounds.double()}, "bounds"),
    (lambda i, p: {"bounds": cs.block_bounds(p, 16)}, "bounds"),
    (lambda i, p: {"patch_t": i.patch_t[:, :60].contiguous()}, "patch_t"),
    (lambda i, p: {"rays_t": i.rays_t.T.contiguous().T}, "rays_t"),
    (lambda i, p: {"rays_t": i.rays_t[:, :100].contiguous()}, "unsupported shape"),
    (lambda i, p: {"num_patches": 513}, "unsupported shape"),
])
def test_codes_launch_refuses(port_cases, fault, match):
    """CPU tables and tables of the wrong shape, type or layout (K1's bounds
    at block 16 among them) never reach K3."""
    port = port_cases["robot"]
    inputs = _codes_inputs(port)
    before = cuda_lib.launch_counts()["sweep_codes"]
    with pytest.raises(ValueError, match=match):
        cc.launch(dataclasses.replace(inputs, **fault(inputs, port)), lists=True, pairs=True)
    assert cuda_lib.launch_counts()["sweep_codes"] == before
    assert "sweep_codes" not in cuda_lib.loaded()


def test_codes_outputs_fields():
    """`launch` returns the outputs with the cull's counts; lists and pairs
    only when a check asks for them."""
    assert [f.name for f in dataclasses.fields(cc.CodesOutputs)] == [
        "code", "dist", "counts", "lists", "pairs"]
    out = cc.CodesOutputs(torch.zeros(2, 2), torch.ones(2, 2), torch.zeros(1))
    assert out.lists is None and out.pairs is None
    assert list(inspect.signature(cc.launch).parameters) == ["inputs", "out", "lists", "pairs"]


# ---------------------------------------------------------------------------
# (f) the entry points that build patches default to the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", [build_from_trimesh, patches_from_numpy, measure_approximation])
def test_patch_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_patch_entry_points_run_on_the_cpu_when_asked(port_cases):
    port = port_cases["sphere"]
    assert port.device.type == "cpu" and port.num_patches == 126
    again = patches_from_numpy({k: v.numpy() for k, v in port.leaves().items()}, device="cpu")
    assert again.device.type == "cpu"
    for a, b in zip(again.leaves().values(), port.leaves().values()):
        assert torch.equal(a, b)
    # the first row of the reference's accuracy table (reference/test.cpp:515)
    err = measure_approximation(0, 7, 3, (1.0, 4.0, 2.0), 3, device="cpu")
    assert err == pytest.approx(0.0022721614, rel=1e-3)


def test_patch_entry_points_without_a_card_raise():
    """Where there is no card the default device fails; nothing falls back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises((RuntimeError, AssertionError)):
        build_from_trimesh(preprocess(make_unit_sphere(7, 3)))
    with pytest.raises((RuntimeError, AssertionError)):
        measure_approximation(0, 7, 3, (1.0, 4.0, 2.0), 3)

"""The kernels' tables built once a lens a trace, on the CPU: the table
kernel's workspace plan, the `PatchTables` record and its plain build
against the JAX package, the ray pack's plain version, the hoist of the
tables out of the chunk loop (`intersect.winner_tables`,
`trace_through_lens`, `intersect_rays`), and the entry points' refusals.

The kernels themselves (csrc/tables.cu) need nvcc and a card:
chip_smoke.py phase t holds the workspace tables and the packed rays
`torch.equal` to these plain versions there, and
tests/test_torch_tables_card.py holds the kernels' reading of the tables
they are handed.
"""
import dataclasses

import numpy as np
import pytest
import torch

from cbtr_tpu.bezier import build_from_trimesh as jax_build
from cbtr_tpu.harness.measure import preprocess as jax_preprocess
from cbtr_tpu.mesh.core import make_unit_sphere as jax_sphere
from cbtr_tpu.models import scenes as jax_scenes
from cbtr_tpu.ops import pallas_sweep as jax_ps

from cbtr_tpu_torch.convert import patches_from_numpy
from cbtr_tpu_torch.harness import preprocess
from cbtr_tpu_torch.mesh.core import make_unit_sphere
from cbtr_tpu_torch.models import design, lens_model, scenes
from cbtr_tpu_torch.models.scenes import LENS_CENTER
from cbtr_tpu_torch.ops import cuda_codes as cc
from cbtr_tpu_torch.ops import cuda_lib
from cbtr_tpu_torch.ops import cuda_sweep as cs
from cbtr_tpu_torch.ops import cuda_tables as ct
from cbtr_tpu_torch.ops import cuda_winner as cw
from cbtr_tpu_torch.ops import intersect as ix
from cbtr_tpu_torch.optics import lens

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def robot():
    """The robot lens (450 patches) at 32^2 rays, on the CPU."""
    return scenes.robot_lens_scene(res=32, device="cpu")


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


def _aligned(nbytes, lead: int = 0):
    """A uint8 vector of nbytes at a 256-byte aligned address (the CPU
    allocator aligns to less), `lead` bytes (a multiple of 256) into its
    storage past the first aligned one."""
    big = torch.zeros(nbytes + 256 + lead, dtype=torch.uint8)
    skip = (-big.data_ptr()) % 256 + lead
    return big[skip:skip + nbytes]


def _rays(n, seed=5):
    rng = np.random.default_rng(seed)
    start = torch.tensor(rng.normal(size=(n, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(
        torch.tensor(rng.normal(size=(n, 3)).astype(np.float32)), dim=-1)
    return start, d


# ---------------------------------------------------------------------------
# the workspace plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_p", [16, 32])
@pytest.mark.parametrize("P", [1, 127, 450, 1800, 16200])
def test_workspace_plan(P, block_p):
    """Offsets 256-byte aligned, in table order, each table's bytes before
    the next; the views carved from a buffer of nbytes have the kernels'
    shapes and types, are contiguous and start at the plan's offsets."""
    plan = ct._workspace_plan(P, block_p)
    P_pad = plan.P_pad
    assert P_pad % 128 == 0 and P <= P_pad < P + 128 and plan.block_p == block_p
    sizes = (4 * 64 * P_pad, 4 * 12 * (P_pad // block_p), 4 * 3 * P_pad, 4 * 8 * P_pad)
    offsets = (plan.patch_t, plan.bounds, plan.nb, plan.boxes)
    assert offsets[0] == 0 and all(o % 256 == 0 for o in offsets)
    for o, size, nxt in zip(offsets, sizes, (*offsets[1:], plan.nbytes)):
        assert o + size <= nxt < o + size + 256
    assert plan.nbytes % 256 == 0
    assert list(plan.as_c_array()) == [P_pad, *offsets, plan.nbytes]
    assert ct.PLAN_FIELDS == ("P_pad", "patch_t", "bounds", "nb", "boxes", "nbytes")
    ws = _aligned(plan.nbytes, lead=256)      # an aligned slice inside a larger storage
    assert ws.storage_offset() >= 256 and ws.data_ptr() % 256 == 0
    views = ct._views(ws, plan)
    for v, dtype, shape, o in zip(views, (torch.float32, torch.float32, torch.int32,
                                          torch.float32),
                                  ((P_pad, 64), (P_pad // block_p, 12), (P_pad, 3), (P_pad, 8)),
                                  offsets, strict=True):
        assert v.dtype == dtype and tuple(v.shape) == shape and v.is_contiguous()
        assert v.data_ptr() - ws.data_ptr() == o
        assert v.untyped_storage().data_ptr() == ws.untyped_storage().data_ptr()
    assert ct._workspace_plan(P, block_p) is plan          # a pure function of the sizes


@pytest.mark.parametrize("P, block_p, match", [(0, 16, "no patches"), (450, 24, "block_p"),
                                                (450, 0, "block_p")])
def test_workspace_plan_refuses(P, block_p, match):
    with pytest.raises(ValueError, match=match):
        ct._workspace_plan(P, block_p)


# ---------------------------------------------------------------------------
# the plain build against the JAX package; K2's clamped neighbours
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("block_p", [16, 32])
@pytest.mark.parametrize("case", ["sphere", "robot"])
def test_patch_tables_reference_matches_jax(jax_cases, case, block_p, clamp):
    """The `PatchTables` of the plain build: its record fields, its three
    tables unpacked in order, the 60 copied columns bit-equal to the JAX
    package's `pack_patch_table`, block spheres and boxes within the bars
    of `test_torch_tables.py` (`_block_spheres_cr`, `_patch_boxes`), and
    the neighbours: -1 on padding rows, or clamped to [0, P) as the JAX
    winner tables clip them (`pack_winner_tables`)."""
    ref, port = jax_cases[case]
    P = ref.num_patches
    tables = ct.build_tables(port, block_p, clamp)
    assert isinstance(tables, ct.PatchTables)
    assert (tables.num_patches, tables.block_p, tables.clamped) == (P, block_p, clamp)
    patch_t, bounds, nb = (x.numpy() for x in tables)
    want_t = np.asarray(jax_ps.pack_patch_table(ref, 128))
    np.testing.assert_array_equal(patch_t[:, :60], want_t[:, :60])
    np.testing.assert_allclose(patch_t[:, 60:63], want_t[:, 60:63], rtol=0, atol=1e-6)
    np.testing.assert_allclose(patch_t[:, 63], want_t[:, 63], rtol=1e-6, atol=1e-6)
    center, radius = jax_ps.patch_spheres(ref)
    P_pad = patch_t.shape[0]
    pad = ((0, P_pad - P), (0, 0))
    c, r = (np.asarray(x) for x in jax_ps._block_spheres_cr(
        np.pad(np.asarray(center), pad), np.pad(np.asarray(radius), (0, P_pad - P)),
        block_p))
    np.testing.assert_allclose(bounds[:, 0:3], c, rtol=0, atol=1e-6)
    np.testing.assert_allclose(bounds[:, 3], r, rtol=1e-6, atol=1e-6)
    lo, hi = (np.pad(np.asarray(x), pad) for x in jax_ps._patch_boxes(
        ref.control_points, center, radius))
    real = (np.arange(P_pad) < P)[:, None]
    lob = np.where(real, lo, np.inf).reshape(-1, block_p, 3).min(axis=1)
    hib = np.where(real, hi, -np.inf).reshape(-1, block_p, 3).max(axis=1)
    finite = np.isfinite(lob).all(axis=1)
    np.testing.assert_allclose(bounds[finite, 4:7], lob[finite], rtol=0, atol=1e-6)
    np.testing.assert_allclose(bounds[finite, 7:10], hib[finite], rtol=0, atol=1e-6)
    if clamp:
        base, _ = jax_ps.pack_winner_tables(ref)
        np.testing.assert_array_equal(nb[:P], np.asarray(base)[:, 64:67].astype(np.int32))
        assert (nb[P:] == 0).all()
    else:
        np.testing.assert_array_equal(nb[:P], np.asarray(ref.neighbours))
        assert (nb[P:] == -1).all()


@pytest.mark.parametrize("case", ["sphere", "robot"])
def test_clamped_neighbours_are_k2s_old_table(jax_cases, case):
    """K2's neighbours come clamped from the build; they equal what
    `cuda_winner.prepare_inputs` made before, K1's table clamped to [0, P)
    (padding rows included), and K1's own stay unclamped."""
    _, port = jax_cases[case]
    start, d = _rays(200)
    k1, k2 = cs.prepare_inputs(port, start, d), cw.prepare_inputs(port, start, d)
    P = port.num_patches
    assert k1.nb.dtype == k2.nb.dtype == torch.int32
    assert torch.equal(k2.nb, k1.nb.clamp(0, P - 1))
    assert torch.equal(k2.nb, ct.build_tables_reference(port, 16, clamp=True).nb)
    assert torch.equal(k1.nb, ct.build_tables_reference(port, 16).nb)
    assert torch.equal(k1.patch_t, k2.patch_t) and torch.equal(k1.bounds, k2.bounds)


def test_pack_rays_on_cpu_is_pad_rays():
    """On the CPU the ray-pack wrapper runs `pad_rays` (nothing builds, no
    launch is counted): rows s, d, 0, 0, padding rays s = 0, d = (1, 0, 0)."""
    before = cuda_lib.launch_counts()["pack_rays"]
    for n in (1, 127, 128, 200):
        start, d = _rays(n)
        got = ct.pack_rays(start, d)
        assert torch.equal(got, cs.pad_rays(start, d))
        R_pad = n + (-n) % 128
        assert got.shape == (8, R_pad) and got.is_contiguous()
        assert torch.equal(got[0:3, :n], start.T) and torch.equal(got[3:6, :n], d.T)
        assert (got[6:] == 0).all() and (got[0:3, n:] == 0).all()
        assert (got[3, n:] == 1).all() and (got[4:6, n:] == 0).all()
    assert cuda_lib.launch_counts()["pack_rays"] == before and "tables" not in cuda_lib.loaded()


# ---------------------------------------------------------------------------
# the hoist: one build a lens a trace
# ---------------------------------------------------------------------------

@pytest.fixture
def builds(monkeypatch):
    """Every `cuda_tables.build_tables` call: [(patches, block_p, clamp)]."""
    calls, build = [], ct.build_tables

    def counted(patches, block_p=cs.BLOCK_P, clamp=False):
        calls.append((patches, block_p, clamp))
        return build(patches, block_p, clamp)

    monkeypatch.setattr(ct, "build_tables", counted)
    return calls


@pytest.fixture
def chunk_tables(monkeypatch):
    """The tables each `intersect._winner_chunk` call was handed."""
    seen, search = [], ix._winner_chunk

    def record(patches, start, direction, backend, tables=None):
        seen.append(tables)
        return search(patches, start, direction, backend, tables=tables)

    monkeypatch.setattr(ix, "_winner_chunk", record)
    return seen


@pytest.mark.parametrize("chunk", [0, 256, 300, 1024])
def test_trace_builds_its_tables_once(robot, builds, chunk_tables, chunk):
    """A chunked trace through the lens builds the tables once, at block 16,
    unclamped (K1's), whatever the chunk count, and hands that one record to
    every chunk of both refractions."""
    sc = robot
    with torch.no_grad():
        lens.trace_through_lens(sc.patches, sc.refractive_index, sc.start, sc.direction,
                                chunk_size=chunk)
    n_chunks = -(-1024 // chunk) if chunk else 1
    assert len(builds) == 1 and builds[0][1:] == (16, False)
    assert len(chunk_tables) == 2 * n_chunks
    assert all(t is chunk_tables[0] for t in chunk_tables)
    assert isinstance(chunk_tables[0], ct.PatchTables)


def test_intersect_rays_builds_once_or_takes_the_callers(robot, builds, chunk_tables):
    """`intersect_rays` builds one before its chunk loop when given none,
    takes the caller's otherwise, and builds none for backend "plain"
    (whose twins build their own, as before)."""
    sc = robot
    with torch.no_grad():
        ix.intersect_rays(sc.patches, sc.start, sc.direction, chunk_size=256)
        assert len(builds) == 1 and len(chunk_tables) == 4
        given = ix.winner_tables(sc.patches)
        ix.intersect_rays(sc.patches, sc.start, sc.direction, chunk_size=256, tables=given)
        assert len(builds) == 2 and all(t is given for t in chunk_tables[4:])
        ix.intersect_rays(sc.patches, sc.start, sc.direction, chunk_size=256,
                          backend="plain")
    assert len(builds) == 2 and chunk_tables[8:] == [None] * 4
    assert ix.winner_tables(sc.patches, "plain") is None


def test_large_lens_tables_are_clamped(builds):
    """Above the fused path's 1024 patches the hoisted tables are K2's:
    neighbours clamped; at K1's largest table (the sphere 17 x 10, 1020
    patches) they are not."""
    refined = scenes.robot_lens_scene(res=8, refine=True, device="cpu")
    tables = ix.winner_tables(refined.patches)
    assert tables.clamped and tables.num_patches == 1800 and builds[-1][1:] == (16, True)
    sphere = scenes.sphere_lens_scene(res=8, sectors=17, belts=10, device="cpu")
    tables = ix.winner_tables(sphere.patches)
    assert not tables.clamped and tables.num_patches == 1020 and builds[-1][1:] == (16, False)


def test_intersect_fn_traces_build_no_tables(robot, builds):
    """The sharded hook (`refract_rays(intersect_fn=)`) sweeps on its own
    tables: `trace_through_lens` builds none for it."""
    sc = robot
    calls = []

    def fn(p, s, d):
        calls.append(1)
        return ix.intersect_rays(p, s, d, backend="plain")

    with torch.no_grad():
        lens.trace_through_lens(sc.patches, sc.refractive_index, sc.start, sc.direction,
                                intersect_fn=fn)
    assert calls == [1, 1] and builds == []


def _loss_and_grads(sc, chunk):
    params = lens_model.params_from_scene(sc)
    target = torch.zeros((16, 16), dtype=torch.float32)
    loss = lens_model.lens_loss(params, sc.start, sc.direction, sc.screen_plane, target,
                                resolution=16, chunk_size=chunk)
    loss.backward()
    return loss.detach(), params.control_points.grad, params.refractive_index.grad


@pytest.mark.parametrize("chunk", [0, 256])
def test_hoist_leaves_images_and_gradients_bit_equal(robot, monkeypatch, chunk):
    """The image, loss and gradients with the tables built once a trace are
    bit-equal to those with the tables built at every chunk (the path
    before the hoist: `winner_tables` giving none).  On the CPU the twins
    build their own, so this holds the record's way down to every chunk;
    tests/test_torch_tables_card.py holds the same on the kernels."""
    sc = robot
    with torch.no_grad():
        img = lens_model.lens_forward(lens_model.params_from_scene(sc), sc.start,
                                      sc.direction, sc.screen_plane, resolution=16,
                                      chunk_size=chunk)
    hoisted = _loss_and_grads(sc, chunk)
    monkeypatch.setattr(ix, "winner_tables", lambda patches, backend="auto": None)
    monkeypatch.setattr(lens, "winner_tables", lambda patches, backend="auto": None)
    with torch.no_grad():
        img_per_chunk = lens_model.lens_forward(lens_model.params_from_scene(sc), sc.start,
                                                sc.direction, sc.screen_plane,
                                                resolution=16, chunk_size=chunk)
    per_chunk = _loss_and_grads(sc, chunk)
    assert float(img.sum()) > 0 and torch.equal(img, img_per_chunk)
    for a, b in zip(hoisted, per_chunk):
        assert torch.equal(a, b)
    assert float(hoisted[1].abs().max()) > 0


def test_design_step_builds_from_its_own_patches(builds):
    """A design step rebuilds its patches from the vertices, and its one
    table build takes that step's patches: after an update the next step's
    tables come from the moved control points (no cache across steps)."""
    mesh = preprocess(make_unit_sphere(5, 2))
    mesh.translate(LENS_CENTER)
    mesh = preprocess(mesh)
    topo, params = design.topology_from_mesh(mesh, device="cpu")
    rng = np.random.default_rng(3)
    n = 256
    d = np.stack([np.ones(n), 0.1 * rng.normal(size=n), 0.1 * rng.normal(size=n)], -1)
    d = torch.tensor((d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32))
    start = torch.zeros((n, 3), dtype=torch.float32)
    screen = torch.tensor([1.0, 0.0, 0.0, 10.0])
    step = design.make_design_step(topo, screen, torch.ones((8, 8)), resolution=8)
    opt = torch.optim.SGD(params.parameters(), lr=1e-2)
    seen = []
    for _ in range(2):
        with torch.no_grad():
            seen.append(design.patches_from_vertices(params, topo).control_points.clone())
        step(params, opt, start, d)
    assert len(builds) == 2
    for (patches, block_p, clamp), cp in zip(builds, seen):
        assert (block_p, clamp) == (16, False)
        assert torch.equal(patches.control_points, cp)
    assert not torch.equal(seen[0], seen[1])


# ---------------------------------------------------------------------------
# refusals: no fallback, no cast
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fault, match", [
    (lambda s, d: (s, d), "CUDA"),
    (lambda s, d: (s.double(), d), "f32"),
    (lambda s, d: (s, d.double()), "f32"),
    (lambda s, d: (s.T.contiguous().T, d), "contiguous"),
    (lambda s, d: (s[:, :2].contiguous(), d), r"\[200, 3\]"),
    (lambda s, d: (s, d[:100]), "direction"),
])
def test_pack_rays_launch_refuses(fault, match):
    """CPU rays, rays of another type, layout or length never reach the
    ray-pack kernel, and nothing is cast or built."""
    start, d = fault(*_rays(200))
    before = cuda_lib.launch_counts()["pack_rays"]
    with pytest.raises(ValueError, match=match):
        ct.launch_pack_rays(start, d)
    assert cuda_lib.launch_counts()["pack_rays"] == before and "tables" not in cuda_lib.loaded()


@pytest.mark.parametrize("wrapper, twin, clamp", [
    (cs.sweep_select, cs.sweep_select_reference, False),
    (cw.sweep_winner, cw.sweep_winner_reference, True),
])
def test_cpu_wrappers_check_and_drop_the_tables(robot, wrapper, twin, clamp):
    """On the CPU a winner wrapper checks the tables it is handed and runs
    its twin, which builds its own: tables whose bounds list no block
    (every radius -1) change nothing there."""
    sc = robot
    tables = ct.build_tables(sc.patches, 16, clamp=clamp)
    empty = dataclasses.replace(tables, bounds=tables.bounds.clone().index_fill_(
        1, torch.tensor([3]), -1.0))
    want = twin(sc.patches, sc.start, sc.direction)
    assert int(want[0].sum()) > 50
    for given in (tables, empty):
        got = wrapper(sc.patches, sc.start, sc.direction, tables=given)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("wrapper, tables, match", [
    (cs.sweep_select, lambda p: ct.build_tables(p, 16, clamp=True), "clamped"),
    (cw.sweep_winner, lambda p: ct.build_tables(p, 16), "clamped"),
    (cs.sweep_select, lambda p: ct.build_tables(p, 32), "block 32"),
    (cw.sweep_winner, lambda p: ct.build_tables(
        p.row(torch.arange(200)), 16, clamp=True), "200 patches"),
])
def test_cpu_wrappers_refuse_other_tables(robot, wrapper, tables, match):
    """The twins drop the tables, but not before the check: K1's wrapper
    refuses clamped tables or another block, K2's unclamped ones or those
    of other patches, as on the card."""
    start, d = _rays(200)
    patches = robot.patches
    with pytest.raises(ValueError, match=match):
        wrapper(patches, start, d, tables=tables(patches))


@pytest.mark.parametrize("prepare, tables, match", [
    (cs.prepare_inputs, lambda p: ct.build_tables(p, 16, clamp=True), "clamped"),
    (cw.prepare_inputs, lambda p: ct.build_tables(p, 16), "clamped"),
    (cs.prepare_inputs, lambda p: ct.build_tables(p, 32), "block 32"),
    (cw.prepare_inputs, lambda p: ct.build_tables(
        p.row(torch.arange(200)), 16, clamp=True), "200 patches"),
])
def test_prepare_inputs_refuses_other_tables(robot, prepare, tables, match):
    """K1 takes unclamped tables at block 16, K2 clamped ones, each of these
    patches; anything else raises before a ray is packed."""
    start, d = _rays(200)
    patches = robot.patches
    with pytest.raises(ValueError, match=match):
        prepare(patches, start, d, tables=tables(patches))


def test_codes_inputs_pack_the_rays(robot, monkeypatch):
    """K3's tables keep one build a call; its rays come from the ray-pack
    wrapper (its plain version on the CPU)."""
    calls = []
    pack = ct.pack_rays
    monkeypatch.setattr(ct, "pack_rays", lambda s, d: calls.append(s.shape) or pack(s, d))
    start, d = _rays(200)
    inputs = cc.prepare_inputs(robot.patches, start, d)
    assert calls == [(200, 3)] and torch.equal(inputs.rays_t, cs.pad_rays(start, d))

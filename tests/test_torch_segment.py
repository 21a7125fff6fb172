"""The fixed-order segment sum (`ops/cuda_segment.py`) on the CPU: its plain
version, the order it states, the two autograd Functions, and the sums of
the JAX package it stands in for.

The kernel itself (csrc/segment_sum.cu) runs only on the card, where
chip_smoke.py holds it bit-equal to `segment_sum_reference`; here every
CPU tensor goes to that plain version.  Inputs are made with numpy from
fixed seeds.  Tolerances: against a float64 sum, 1e-5 relative of the
segment's absolute sum (f32 rounding of up to 20,000 terms); against a
left fold, `jax.ops.segment_sum` and `jax.grad` of `jnp.take`, bit-equal
while no segment is longer than GROUP rows (XLA's CPU scatter-add and a
sequential `index_add_` fold in row order, as level 0 does), and within the
float64 bar above it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbtr_tpu_torch.harness.determinism import divergent_sites
from cbtr_tpu_torch.ops import cuda_segment as sg
from cbtr_tpu_torch.ops import cuda_sweep as cs
from cbtr_tpu_torch.ops import intersect as ix
from cbtr_tpu_torch.render import render

torch.set_num_threads(2)
L = sg.GROUP


def _case(seed, n, s, c, low=0, high=None):
    rng = np.random.default_rng(seed)
    ids = rng.integers(low, s if high is None else high, n).astype(np.int64)
    vals = rng.normal(size=(n, c)).astype(np.float32)
    return ids, vals


def _sum64(ids, vals, s):
    out = np.zeros((s, vals.shape[1]))
    mag = np.zeros((s, vals.shape[1]))
    for r, i in enumerate(ids):
        if 0 <= i < s:
            out[i] += vals[r]
            mag[i] += np.abs(vals[r])
    return out, mag


def _left_fold(ids, vals, s):
    """What a sequential index_add_ into zeros does: row by row, in f32."""
    out = np.zeros((s, vals.shape[1]), np.float32)
    for r, i in enumerate(ids):
        if 0 <= i < s:
            out[i] = out[i] + vals[r]
    return out


def _tree(rows):
    """The module's order for one segment, written out: runs of GROUP folded
    from +0.0, level by level."""
    level = np.asarray(rows, np.float32)
    if level.shape[0] == 0:
        return np.zeros(level.shape[1:], np.float32)
    while True:
        nodes = []
        for g in range(0, level.shape[0], L):
            acc = np.zeros(level.shape[1:], np.float32)
            for x in level[g:g + L]:
                acc = acc + x
            nodes.append(acc)
        level = np.asarray(nodes)
        if level.shape[0] == 1:
            return level[0]


def _ref(ids, vals, s):
    return sg.segment_sum_reference(torch.tensor(ids), torch.tensor(vals), s).numpy()


@pytest.mark.parametrize("n,s,c", [(2000, 37, 3), (20000, 6, 1), (5000, 450, 60),
                                   (300, 1000, 2)])
def test_reference_matches_float64_sum(n, s, c):
    ids, vals = _case(n + s, n, s, c)
    got = _ref(ids, vals, s)
    want, mag = _sum64(ids, vals, s)
    assert got.dtype == np.float32 and got.shape == (s, c)
    assert np.all(np.abs(got - want) <= 1e-5 * mag + 1e-30)


@pytest.mark.parametrize("n,s,c", [(3000, 40, 60), (900, 7, 1), (4000, 300, 5)])
def test_reference_is_the_left_fold_while_segments_fit_a_group(n, s, c):
    """No segment longer than GROUP: bit for bit the left fold of the rows
    in ascending source index (the CPU's index_add_, so the port's CPU
    results of earlier PRs do not move); dropped ids included."""
    ids, vals = _case(7 * n, n, s, c, low=-3, high=s + 3)
    assert np.bincount(ids[(ids >= 0) & (ids < s)], minlength=s).max() <= L
    got = _ref(ids, vals, s)
    np.testing.assert_array_equal(got, _left_fold(ids, vals, s))
    z = torch.zeros((s, c))
    keep = (ids >= 0) & (ids < s)
    z.index_add_(0, torch.tensor(ids[keep]), torch.tensor(vals[keep]))
    assert torch.equal(torch.tensor(got), z)


@pytest.mark.parametrize("length", [0, 1, L - 1, L, L + 1, 2 * L + 7, L * L, L * L + 1])
def test_segment_lengths_follow_the_stated_tree(length):
    """One segment of each edge length between empty ones, interleaved with
    other segments' rows: the module's GROUP-ary tree, bit for bit."""
    rng = np.random.default_rng(length)
    other = 300
    ids = np.concatenate([np.full(length, 2), rng.choice([0, 4], other)])
    perm = rng.permutation(ids.shape[0])
    ids = ids[perm]
    vals = (rng.normal(size=(ids.shape[0], 2))
            * 10.0 ** rng.integers(-3, 4, (ids.shape[0], 1))).astype(np.float32)
    got = _ref(ids, vals, 5)
    for s in range(5):
        np.testing.assert_array_equal(got[s], _tree(vals[ids == s]))
    assert np.all(got[[1, 3]] == 0)
    if length > L:
        # the tree is not the left fold here, but within f32 rounding of it
        want, mag = _sum64(ids, vals, 5)
        assert np.all(np.abs(got - want) <= 1e-5 * mag)


def test_a_hot_segment_of_most_rows():
    """85 % of the rows in segment 0 (the misses that gather patch 0; the
    dead rays at the image centre): the tree, and the float64 sum."""
    rng = np.random.default_rng(85)
    n = 40000
    ids = np.where(rng.random(n) < 0.85, 0, rng.integers(1, 450, n))
    vals = rng.normal(size=(n, 4)).astype(np.float32)
    got = _ref(ids, vals, 450)
    np.testing.assert_array_equal(got[0], _tree(vals[ids == 0]))
    want, mag = _sum64(ids, vals, 450)
    assert np.all(np.abs(got - want) <= 1e-5 * mag + 1e-30)


def test_dropped_ids_empty_and_degenerate_shapes():
    vals = torch.tensor([[1.0], [2.0], [4.0], [8.0]])
    ids = torch.tensor([-1, 3, 7, 1])
    got = sg.segment_sum(ids, vals, 4)
    assert torch.equal(got, torch.tensor([[0.0], [8.0], [0.0], [2.0]]))
    assert sg.segment_sum(ids[:0], vals[:0], 3).shape == (3, 1)
    assert bool((sg.segment_sum(ids[:0], vals[:0], 3) == 0).all())
    assert sg.segment_sum(ids, vals, 0).shape == (0, 1)
    assert sg.segment_sum(ids, vals[:, :0], 4).shape == (4, 0)
    assert torch.equal(sg.segment_sum(torch.full((4,), 9), vals, 4), torch.zeros(4, 1))
    with pytest.raises(ValueError):
        sg.segment_sum(ids[:3], vals, 4)
    with pytest.raises(ValueError):
        sg.segment_sum(ids.float(), vals, 4)


def test_negative_zero_becomes_positive_zero():
    """A fold from +0.0: a segment of -0.0 rows sums to +0.0, as index_add_
    into zeros gives; an empty segment is +0.0."""
    vals = torch.tensor([[-0.0], [-0.0], [-0.0], [1.0], [-1.0]])
    got = sg.segment_sum(torch.tensor([0, 1, 1, 2, 2]), vals, 4)
    assert torch.equal(got, torch.zeros(4, 1))
    assert not torch.signbit(got).any()
    z = torch.zeros(4, 1).index_add_(0, torch.tensor([0, 1, 1, 2, 2]), vals)
    assert torch.equal(torch.signbit(got), torch.signbit(z))


@pytest.mark.parametrize("n,s,c", [(3000, 40, 60), (5000, 450, 60), (20000, 5, 1)])
def test_reference_against_jax_segment_sum(n, s, c):
    """jax.ops.segment_sum on the CPU: bit-equal while every segment fits a
    group (XLA's scatter-add folds rows in order), within the float64 bar
    otherwise (the 20,000 rows into 5 segments)."""
    ids, vals = _case(n * 3 + s, n, s, c)
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(ids.astype(np.int32)), s))
    got = _ref(ids, vals, s)
    if np.bincount(ids, minlength=s).max() <= L:
        np.testing.assert_array_equal(got, ref)
    else:
        _, mag = _sum64(ids, vals, s)
        assert np.all(np.abs(got - ref) <= 2e-5 * mag)


@pytest.mark.parametrize("n,s,c", [(3000, 40, 60), (4000, 5, 3)])
def test_gather_rows_gradient_against_jax_take(n, s, c):
    """The recompute's gather: jax.grad of jnp.take(table, idx, axis=0)
    against gather_rows' backward, bit-equal under the left-fold condition,
    else within the float64 bar."""
    ids, g = _case(n + 11 * s, n, s, c)
    table = np.random.default_rng(s).normal(size=(s, c)).astype(np.float32)
    jg = np.asarray(jax.grad(lambda t: jnp.sum(jnp.take(t, jnp.asarray(ids), axis=0)
                                               * jnp.asarray(g)))(jnp.asarray(table)))
    tt = torch.tensor(table, requires_grad=True)
    (sg.gather_rows(tt, torch.tensor(ids)) * torch.tensor(g)).sum().backward()
    if np.bincount(ids, minlength=s).max() <= L:
        np.testing.assert_array_equal(tt.grad.numpy(), jg)
    else:
        _, mag = _sum64(ids, g, s)
        assert np.all(np.abs(tt.grad.numpy() - jg) <= 2e-5 * mag)


@pytest.mark.parametrize("shape", [(50, 60), (50, 10, 3), (7,)])
def test_gather_rows_forward_is_index_select(shape):
    rng = np.random.default_rng(len(shape))
    table = torch.tensor(rng.normal(size=shape).astype(np.float32))
    idx = torch.tensor(rng.integers(0, shape[0], 500))
    assert torch.equal(sg.gather_rows(table, idx), torch.index_select(table, 0, idx))
    with torch.no_grad():
        assert torch.equal(sg.gather_rows(table, idx), torch.index_select(table, 0, idx))


def test_gradcheck_both_functions_f64():
    rng = np.random.default_rng(5)
    table = torch.tensor(rng.normal(size=(20, 4)), requires_grad=True)
    idx = torch.tensor(rng.integers(0, 20, 300))
    assert torch.autograd.gradcheck(sg.gather_rows, (table, idx))
    vals = torch.tensor(rng.normal(size=(300, 3)), requires_grad=True)
    ids = torch.tensor(rng.integers(-2, 22, 300))
    assert torch.autograd.gradcheck(lambda v: sg.segment_sum(ids, v, 20), (vals,))


def test_each_function_is_the_adjoint_of_the_other():
    """<gather(t), g> = <t, segment_sum(g)> in f64, and each backward is the
    other's forward."""
    rng = np.random.default_rng(6)
    t = torch.tensor(rng.normal(size=(30, 5)), requires_grad=True)
    idx = torch.tensor(rng.integers(0, 30, 400))
    g = torch.tensor(rng.normal(size=(400, 5)))
    lhs = (sg.gather_rows(t, idx) * g).sum()
    rhs = (t * sg.segment_sum(idx, g, 30)).sum()
    torch.testing.assert_close(lhs, rhs, rtol=1e-12, atol=1e-12)
    lhs.backward()
    assert torch.equal(t.grad, sg.segment_sum(idx, g, 30))
    v = g.clone().requires_grad_(True)
    out = sg.segment_sum(idx, v, 30)
    out.backward(t.detach())
    assert torch.equal(v.grad, torch.index_select(t.detach(), 0, idx))


def test_non_contiguous_incoming_gradient():
    rng = np.random.default_rng(8)
    t = torch.tensor(rng.normal(size=(40, 6)).astype(np.float32), requires_grad=True)
    idx = torch.tensor(rng.integers(0, 40, 700))
    rows = sg.gather_rows(t, idx)
    w = torch.tensor(rng.normal(size=(6, 700)).astype(np.float32))
    (rows * w.T).sum().backward()           # the incoming gradient is w.T
    want = torch.zeros(40, 6).index_add_(0, idx, w.T.contiguous())
    assert torch.equal(t.grad, sg.segment_sum(idx, w.T.contiguous(), 40))
    torch.testing.assert_close(t.grad, want, rtol=1e-5, atol=1e-5)


def test_cpu_tensors_never_build_or_launch():
    before = sg.segment_sum.launches
    sg.segment_sum(torch.tensor([0, 1]), torch.ones(2, 3), 2)
    assert sg.segment_sum.launches == before and "segment_sum" not in cs._libraries
    with pytest.raises(ValueError, match="CUDA"):
        sg.launch(torch.tensor([0, 1]), torch.ones(2, 3), 2)
    assert "segment_sum" not in cs._libraries


def test_runs_under_torch_deterministic_mode():
    rng = np.random.default_rng(9)
    t = torch.tensor(rng.normal(size=(30, 5)).astype(np.float32), requires_grad=True)
    idx = torch.tensor(rng.integers(0, 30, 1000))
    torch.use_deterministic_algorithms(True)
    try:
        sg.gather_rows(t, idx).sum().backward()
        out = sg.segment_sum(idx, torch.ones(1000, 2), 30)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(t.grad[:, 0], out[:, 0])


def test_splat_scatter_path_is_the_four_pass_left_fold(monkeypatch):
    """The scatter splat as one segment sum over the passes 00, 01, 10, 11:
    bit-equal to the four sequential index_adds it replaces (no pixel takes
    more than GROUP contributions here), and its gradient to theirs."""
    monkeypatch.setattr(render, "_SPLAT_MATMUL_MAX_BYTES", 0)
    rng = np.random.default_rng(12)
    pts = torch.tensor(rng.normal(size=(3000, 2)).astype(np.float32) * 2.0,
                       requires_grad=True)
    w = torch.tensor(rng.uniform(0.0, 1.0, 3000).astype(np.float32), requires_grad=True)
    res, extent = 32, 4.0
    img = render.splat_bilinear(pts, w, extent, res)
    xy = (pts / (2.0 * extent) + 0.5) * res - 0.5
    x0i, frac = render._floor_index(xy, res)
    old = torch.zeros(res * res)
    for dx in (0, 1):
        for dy in (0, 1):
            wx = frac[:, 0] if dx else 1.0 - frac[:, 0]
            wy = frac[:, 1] if dy else 1.0 - frac[:, 1]
            ixx, iyy = x0i[:, 0] + dx, x0i[:, 1] + dy
            inside = (ixx >= 0) & (ixx < res) & (iyy >= 0) & (iyy < res)
            old = old.index_add(0, ixx.clamp(0, res - 1) * res + iyy.clamp(0, res - 1),
                                torch.where(inside, w * wx * wy, 0.0))
    assert torch.equal(img, old.reshape(res, res))
    g = torch.tensor(rng.normal(size=(res, res)).astype(np.float32))
    got = torch.autograd.grad((img * g).sum(), (pts, w))
    want = torch.autograd.grad((old.reshape(res, res) * g).sum(), (pts, w))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_chunked_recompute_backward_under_checkpoint():
    """intersect_rays in chunks checkpoints each chunk's recompute, whose
    gather now has a once-differentiable backward: it runs, twice bit-equal,
    and within f32 rounding of the unchunked gradient."""
    from cbtr_tpu_torch.models import sphere_lens_scene

    sc = sphere_lens_scene(res=24, sectors=9, belts=4, device="cpu")

    def grad(chunk):
        cp = sc.patches.control_points.clone().requires_grad_(True)
        patches = sc.patches.replace(control_points=cp)
        hit = ix.intersect_rays(patches, sc.start, sc.direction, chunk_size=chunk)
        ok = hit.what == ix.WHAT_INTERSECT
        (hit.point[ok].sum() + hit.normal[ok].square().sum()).backward()
        return cp.grad

    a, b, full = grad(128), grad(128), grad(0)
    assert torch.equal(a, b) and float(full.abs().max()) > 0
    torch.testing.assert_close(a, full, rtol=1e-4, atol=1e-4)


def test_probe_finds_an_order_dependent_node_and_none_in_the_loss():
    """harness/determinism.divergent_sites: a backward that moves between
    runs is named, the nodes after it are not; the robot lens loss on the
    CPU has no such node."""

    class Drifting(torch.autograd.Function):
        calls = 0

        @staticmethod
        def forward(ctx, x):
            return x * 2.0

        @staticmethod
        def backward(ctx, g):
            Drifting.calls += 1
            return g * 2.0 + 1e-3 * (Drifting.calls % 2)

    x = torch.randn(16, requires_grad=True)
    sites, nodes, differ = divergent_sites(lambda: (Drifting.apply(x * 3.0) ** 2).sum())
    assert [name for _, name in sites] == ["DriftingBackward"] and differ == 2 and nodes == 5

    from cbtr_tpu_torch.models import lens_model, sphere_lens_scene

    sc = sphere_lens_scene(res=24, sectors=9, belts=4, device="cpu")
    params = lens_model.params_from_scene(sc)
    target = torch.zeros((16, 16))

    def loss():
        params.zero_grad(set_to_none=True)
        return lens_model.lens_loss(params, sc.start, sc.direction, sc.screen_plane, target,
                                    resolution=16)

    sites, nodes, differ = divergent_sites(loss)
    assert sites == [] and differ == 0 and nodes > 100

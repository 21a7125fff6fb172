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
import contextlib
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbtr_tpu_torch.harness.determinism import divergent_sites
from cbtr_tpu_torch.ops import cuda_lib
from cbtr_tpu_torch.ops import cuda_segment as sg
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
    before = cuda_lib.launch_counts()["segment_sum"]
    sg.segment_sum(torch.tensor([0, 1]), torch.ones(2, 3), 2)
    assert cuda_lib.launch_counts()["segment_sum"] == before
    assert "segment_sum" not in cuda_lib.loaded()
    with pytest.raises(ValueError, match="CUDA"):
        sg.launch(torch.tensor([0, 1]), torch.ones(2, 3), 2)
    assert "segment_sum" not in cuda_lib.loaded()


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


# ---------------------------------------------------------------------------
# the kernel's grouping, emulated in NumPy stage by stage as
# csrc/segment_sum.cu runs it, against torch's stable sort and the plain
# version's `_grouping` and `_node_bases`

WARP_KEYS = 32 * sg.SORT_ITEMS
# robot 64^2: gradient entries the tree moves against the sequential fold
ROBOT_TREE_DIFFERS = 0


def _keys(ids, s):
    return np.where((ids >= 0) & (ids < s), ids, s).astype(np.int64)


def _tile_histograms(keys, shift, width, subs):
    """tile_histogram: counts [digits, tiles], digit-major, a block counting
    `subs` tiles one after another and storing each digit's counts of them
    side by side."""
    digits, tiles = 1 << width, -(-keys.shape[0] // sg.TILE)
    d = (keys >> shift) & (digits - 1)
    counts = np.zeros(digits * tiles, np.int64)
    for block in range(-(-tiles // subs)):
        mine = min(subs, tiles - block * subs)
        kept = np.zeros((digits, mine), np.int64)
        for j in range(mine):
            t = block * subs + j
            kept[:, j] = np.bincount(d[t * sg.TILE:(t + 1) * sg.TILE], minlength=digits)
        for e in range(digits * mine):          # the store loop, e = d * mine + j
            counts[e // mine * tiles + block * subs + e % mine] = kept[e // mine, e % mine]
    return counts.reshape(digits, tiles)


def _exclusive_scan(x):
    """scan_digits / scan_nodes: the exclusive prefix sums, in flat order."""
    flat = np.asarray(x, np.int64).reshape(-1)
    return (np.cumsum(flat) - flat).reshape(np.shape(x))


def _radix_pass(keys, payload, shift, width, subs):
    """One pass: the tile histograms, their digit-major scan, then each
    tile's stable scatter: each warp's run of 32 x SORT_ITEMS keys ranked in
    rounds of 32 lanes (a lane's rank is its warp's running count of its
    digit plus the popcount of the lower lanes of equal digit), the warps'
    counts prefix-summed in warp order."""
    n = keys.shape[0]
    digits = 1 << width
    bases = _exclusive_scan(_tile_histograms(keys, shift, width, subs))
    d = (keys >> shift) & (digits - 1)
    slot = np.full(n, -1, np.int64)
    lanes = np.arange(32)
    for t in range(bases.shape[1]):
        warp_run = np.zeros((sg.SORT_WARPS, digits), np.int64)
        ranked = []
        for w in range(sg.SORT_WARPS):
            first = t * sg.TILE + w * WARP_KEYS
            for r in range(sg.SORT_ITEMS):
                i = first + r * 32 + lanes
                i = i[i < n]
                if i.size == 0:
                    break
                dd = d[i]
                same = dd[:, None] == dd[None, :]          # __match_any_sync
                lower = np.tril(same, -1).sum(axis=1)      # __popc(peers & lanemask_lt)
                ranked.append((w, i, warp_run[w, dd] + lower))
                np.add.at(warp_run[w], dd, 1)
        before = np.cumsum(warp_run, 0) - warp_run           # the warps in order
        for w, i, rank in ranked:
            slot[i] = bases[d[i], t] + before[w, d[i]] + rank
    assert np.array_equal(np.sort(slot), np.arange(n))
    out_keys, out_payload = np.empty_like(keys), np.empty_like(payload)
    out_keys[slot], out_payload[slot] = keys, payload
    return out_keys, out_payload, bases


def _emulated_grouping(ids, s, subs=None):
    """The kernel's grouping: (sorted keys, payload = source rows, offsets);
    subs: the plan's, or forced."""
    keys = _keys(ids, s)
    payload = np.arange(keys.shape[0], dtype=np.int64)
    plan = sg._workspace_plan(max(keys.shape[0], 1), s, 1)
    shift = 0
    for width in plan.widths:
        keys, payload, bases = _radix_pass(keys, payload, shift, width, subs or plan.subs)
        shift += width
    if len(plan.widths) == 1:
        # scan_digits' side output: tile 0's slot of digit d
        offsets = bases[:s + 1, 0] if bases.shape[1] else np.zeros(s + 1, np.int64)
    else:
        # segment_bounds: one binary search of the sorted keys a segment
        offsets = np.searchsorted(keys, np.arange(s + 1), side="left")
    return keys, payload, offsets


def _emulated_node_bases(offsets, levels):
    """scan_nodes over [levels x (S + 1)], each row minus its first element."""
    n = np.diff(offsets)
    rows = []
    for k in range(levels):
        below, span = L ** k, L ** (k + 1)
        rows.append(np.append(np.where(n > (0 if k == 0 else below), -(-n // span), 0), 0))
    flat = _exclusive_scan(np.asarray(rows))
    return flat - flat[:, :1]


RADIX_CASES = {
    "dropped ids": (5000, 450, -40, 500),
    "every row on one key": (9000, 450, 7, 8),
    "S + 1 a power of two": (7000, 511, 0, 511),
    "one past a power of two": (7000, 512, 0, 512),
    "N not a multiple of the tile": (2 * sg.TILE + 77, 1800, -3, 1803),
    "N = 0": (0, 450, 0, 450),
    "two passes, S = 16,200": (9000, 16200, -5, 16210),
    "two passes, S = 1024^2": (9000, 1 << 20, 0, 1 << 20),
}


@pytest.mark.parametrize("case", list(RADIX_CASES))
def test_radix_sort_emulation_is_torch_stable_sort(case):
    """The kernel's passes, tile by tile and warp by warp, give the
    permutation of torch.sort(keys, stable=True) (dropped ids keyed S sort
    last), and its offsets and node bases are the plain version's."""
    n, s, low, high = RADIX_CASES[case]
    rng = np.random.default_rng(n + s)
    ids = rng.integers(low, high, n)
    if case == "every row on one key" or case == "N not a multiple of the tile":
        ids[rng.random(n) < 0.85] = 0          # a hot segment, as patch 0's misses
    keys, payload, offsets = _emulated_grouping(ids, s)
    want_keys, want_perm, want_offsets = sg._grouping(torch.tensor(ids), s)
    assert np.array_equal(payload, want_perm.numpy())
    assert np.array_equal(keys, want_keys.numpy())
    assert np.array_equal(offsets, want_offsets.numpy())
    levels = sg._levels(n)
    bases = _emulated_node_bases(offsets, levels)
    assert np.array_equal(bases, sg._node_bases(want_offsets[1:] - want_offsets[:-1],
                                                levels).numpy())


@pytest.mark.parametrize("subs,s", [(2, 450), (3, 1800), (3, 16200)])
def test_radix_sort_emulation_with_histogram_blocks_of_several_tiles(subs, s):
    """A histogram block counting several tiles (the plan's choice from 2^22
    rows, too many for this emulation, forced here on 2.5 blocks of tiles):
    the same counts, still torch's stable sort."""
    n = subs * sg.TILE * 5 // 2 + 31
    rng = np.random.default_rng(subs * s)
    ids = rng.integers(-2, s + 2, n)
    ids[rng.random(n) < 0.5] = s // 2
    keys, payload, offsets = _emulated_grouping(ids, s, subs)
    want_keys, want_perm, want_offsets = sg._grouping(torch.tensor(ids), s)
    assert np.array_equal(payload, want_perm.numpy())
    assert np.array_equal(offsets, want_offsets.numpy())


@pytest.mark.parametrize("s,widths", [(1, (1,)), (450, (9,)), (1800, (11,)), (2047, (11,)),
                                      (2048, (6, 6)), (16200, (7, 7)), (1 << 20, (11, 10)),
                                      (2**29 + 5, (10, 10, 10))])
def test_workspace_plan_passes_and_digit_widths(s, widths):
    """bits = ceil(log2(S + 1)) (S keys the dropped rows), in passes of at
    most 11 bits split evenly: one pass at 450 and 1,800 segments and up to
    2,047, two at 2,048, 16,200 and 1024^2, three above 2^22."""
    plan = sg._workspace_plan(256, s, 60)
    assert plan.widths == widths and sum(widths) == plan.bits == s.bit_length()
    assert (1 << plan.bits) >= s + 1 > (1 << (plan.bits - 1))
    assert plan.fields["passes"] == len(widths)
    assert plan.fields["width0"] == widths[0]


@pytest.mark.parametrize("n,s,c", [(262144, 450, 60), (1 << 20, 450, 60), (1 << 26, 1 << 20, 1),
                                   (262144, 16200, 60), (1, 1, 1), (4097, 3, 2)])
def test_workspace_plan_layout(n, s, c):
    """Every buffer of the workspace at a 256-byte boundary, none
    overlapping, the cleared bytes (tickets and look-back words) first; the
    tiles, levels and scan blocks those the kernel computes; the grids'
    node bounds hold the nodes of the worst segment counts."""
    plan = sg._workspace_plan(n, s, c)
    f = plan.fields
    passes, levels = len(plan.widths), plan.levels
    assert plan.tiles == -(-n // sg.TILE) and levels == sg._levels(n)
    assert plan.subs == max(1, min(sg.MAX_SUBS, plan.tiles // sg._MIN_HISTOGRAM_BLOCKS))
    sizes = {"tickets": 16, "counts": 4 * (1 << max(plan.widths)) * plan.tiles,
             "offsets": 4 * (s + 1), "node_bases": 4 * levels * (s + 1),
             "payload0": 4 * n}
    sizes.update({f"status{q}": 8 * b for q, b in enumerate(plan.scan_blocks)})
    if passes > 1:
        sizes.update(keys0=4 * n, keys1=4 * n, payload1=4 * n)
    if levels > 1:
        sizes.update(scratch0=4 * plan.max_nodes[0] * c, scratch1=4 * plan.max_nodes[0] * c)
    spans = sorted((f[name], f[name] + size) for name, size in sizes.items())
    assert all(a % 256 == 0 for a, _ in spans)
    assert all(b <= a2 for (_, b), (a2, _) in zip(spans, spans[1:]))
    assert spans[-1][1] <= plan.nbytes
    assert f["memset"] >= max(f[f"status{q}"] + 8 * b for q, b in enumerate(plan.scan_blocks))
    assert f["memset"] <= min(f[k] for k in ("counts", "offsets", "node_bases", "payload0"))
    assert plan.scan_blocks == tuple(-(-m // sg.SCAN_TILE) for m in
                                     [(1 << w) * plan.tiles for w in plan.widths]
                                     + [levels * (s + 1)])
    # the worst case for each level's nodes: every segment but one a single
    # row, the rest on one segment; or the rows spread evenly
    for counts in (np.array([n - min(s, n) + 1] + [1] * (min(s, n) - 1)),
                   np.full(min(s, n), n // min(s, n))):
        nodes = sg._node_bases(torch.tensor(counts), levels)[:, -1]
        assert all(int(x) <= m for x, m in zip(nodes, plan.max_nodes))


_SOURCE = Path(sg.__file__).resolve().parent.parent / "csrc" / "segment_sum.cu"


def _field_enum():
    """{name: value} of csrc/segment_sum.cu's `enum Field`, as C numbers it
    (an enumerator without `=` is the one before it plus one)."""
    body = re.search(r"enum Field \{(.*?)\};", _SOURCE.read_text(), re.S).group(1)
    values, last = {}, -1
    for item in (x.strip() for x in body.split(",") if x.strip()):
        m = re.fullmatch(r"(F_\w+)(?:\s*=\s*(F_\w+)\s*\+\s*(\d+))?", item)
        assert m, item
        last = values[m[2]] + int(m[3]) if m[2] else last + 1
        values[m[1]] = last
    return values


def test_plan_fields_are_the_kernel_field_enum():
    """The plan the wrapper hands the C entry point is read by csrc/
    segment_sum.cu's `enum Field`: each enumerator F_NAME sits at the index
    of PLAN_FIELDS' "name", one of several ("width0", "nodes0", ...)
    followed by its siblings up to the next enumerator, and the last ends
    PLAN_FIELDS."""
    values = _field_enum()
    ordered = sorted(values.items(), key=lambda kv: kv[1])
    ends = [v for _, v in ordered[1:]] + [len(sg.PLAN_FIELDS)]
    assert ordered[0][1] == 0
    for (name, value), end in zip(ordered, ends):
        field = name[2:].lower()
        assert sg.PLAN_FIELDS[value] == field, (name, value)
        if end - value > 1:
            stem = field[:-1]
            assert field.endswith("0") and sg.PLAN_FIELDS[value:end] == tuple(
                f"{stem}{j}" for j in range(end - value)), (name, sg.PLAN_FIELDS[value:end])
        else:
            assert end - value == 1, name


@pytest.mark.parametrize("name, value", [
    ("GROUP", sg.GROUP), ("SORT_THREADS", sg.SORT_WARPS * 32), ("ITEMS", sg.SORT_ITEMS),
    ("TILE", sg.TILE), ("MAX_SUBS", sg.MAX_SUBS), ("MAX_DIGITS", 1 << sg.MAX_DIGIT_BITS),
    ("SCAN_TILE", sg.SCAN_TILE),
])
def test_wrapper_constants_are_the_kernel_constants(name, value):
    """The sizes the plan is computed from are the kernel's own constants
    (csrc/segment_sum.cu, evaluated from its `constexpr int` lines)."""
    consts = {}
    for m in re.finditer(r"constexpr int (\w+) = ([^;]+);", _SOURCE.read_text()):
        consts[m[1]] = eval(m[2], {}, dict(consts))
    assert consts[name] == value


def test_workspace_plan_int32_limits():
    """Row positions, payloads, offsets and node ids are int32 in the
    kernel: 2^31 - 1 rows plan (their node ids fit while the segments are
    few), 2^31 raise, as do segment counts outside [1, 2^31 - 1)."""
    plan = sg._workspace_plan(2**31 - 1, 450, 1)
    assert plan.levels == 4 and sum(plan.max_nodes) < 2**31
    assert plan.nbytes > 2 * 4 * (2**31 - 1) // 2
    for n in (2**31, 2**32 + 5):
        with pytest.raises(ValueError, match="2\\^31 - 1"):
            sg._workspace_plan(n, 450, 60)
    with pytest.raises(ValueError, match="node ids"):
        sg._workspace_plan(2**31 - 1, 2**30, 1)
    with pytest.raises(ValueError):
        sg._workspace_plan(1000, 0, 1)
    with pytest.raises(ValueError):
        sg._workspace_plan(1000, 2**31 - 1, 1)


class _StubEntry:
    """Stands in for the kernel's C entry point on a CPU-only run: records
    the arguments of each call."""

    def __init__(self):
        self.argtypes, self.restype, self.calls = None, None, []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_cuda_path_calls_no_sort_searchsorted_cumsum(monkeypatch, dtype):
    """The wrapper's CUDA path (`_enqueue`, everything `launch` does after
    its device checks) on CPU tensors with the library and the stream
    stubbed, with torch.sort, argsort, searchsorted, cumsum and every read
    back to the host made to raise: one zeroed output, one workspace of the
    plan's size, one C call with the ids as they are (no conversion)."""
    def banned(name):
        def raise_(*args, **kwargs):
            raise AssertionError(f"the CUDA path called {name}")
        return raise_

    for name in ("sort", "argsort", "searchsorted", "cumsum", "bincount", "unique"):
        monkeypatch.setattr(torch, name, banned(f"torch.{name}"))
    for name in ("item", "tolist", "cpu", "numpy", "sort", "cumsum", "argsort"):
        monkeypatch.setattr(torch.Tensor, name, banned(f"Tensor.{name}"))
    entry = _StubEntry()

    class _Stream:
        cuda_stream = 1234

    monkeypatch.setattr(cuda_lib, "library", lambda stem: SimpleNamespace(cbtr_segment_sum=entry))
    monkeypatch.setattr(cuda_lib, "_launches", dict.fromkeys(cuda_lib.KERNELS, 0))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: _Stream())
    ids = torch.arange(5000, dtype=dtype) % 451      # 450: dropped
    vals = torch.ones((5000, 60))
    out = sg._enqueue(ids, vals, 450)
    assert cuda_lib.launch_counts()["segment_sum"] == 1
    assert out.shape == (450, 60) and not bool(out.any())
    (args,) = entry.calls
    assert len(args) == len(entry.argtypes)
    plan = sg._workspace_plan(5000, 450, 60)
    assert args[0] == ids.data_ptr() and args[1] == ids.element_size()
    assert args[5:8] == (5000, 450, 60) and args[9] == 1234
    assert list(args[8]) == [plan.fields[f] for f in sg.PLAN_FIELDS]
    # nothing to add: no call
    assert not bool(sg._enqueue(ids[:0], vals[:0], 450).any()) and len(entry.calls) == 1
    assert cuda_lib.launch_counts()["segment_sum"] == 1


def test_robot_gradient_tree_against_sequential_index_add():
    """The robot lens (P = 450) at 64^2 rays on the CPU: the control-point
    gradient with the module's 256-ary tree against the same backward with
    a sequential `index_add_` (the left fold, which XLA's scatter-add
    performs).  Patch 0's segment outgrows GROUP rows (the misses clamped to
    it), but all its rows are zero (a miss's row gradient is 0, and no ray
    of this grid hits patch 0), and every other segment fits a group, so no
    entry's bits differ (ROADMAP queue C records the count)."""
    from cbtr_tpu_torch.models import lens_model, robot_lens_scene

    sc = robot_lens_scene(res=64, device="cpu")
    target = torch.zeros((32, 32))
    longest = []

    def grad():
        params = lens_model.params_from_scene(sc)
        lens_model.lens_loss(params, sc.start, sc.direction, sc.screen_plane, target,
                             resolution=32).backward()
        return params.control_points.grad.clone()

    real = sg._sum

    def tree_sum(ids, vals, num_segments):
        nonzero = (vals != 0).any(dim=1)
        longest.append((int(torch.bincount(ids, minlength=num_segments).max()),
                        int(torch.bincount(ids[nonzero], minlength=num_segments).max())))
        return real(ids, vals, num_segments)

    def sequential(ids, vals, num_segments):
        keep = (ids >= 0) & (ids < num_segments)
        return torch.zeros((num_segments, vals.shape[1]), dtype=vals.dtype).index_add_(
            0, ids[keep], vals[keep])

    try:
        sg._sum = tree_sum
        tree = grad()
        sg._sum = sequential
        fold = grad()
    finally:
        sg._sum = real
    assert len(longest) == 2
    assert all(rows > L >= nonzero_rows for rows, nonzero_rows in longest), longest
    count = int((tree != fold).sum())
    assert count == ROBOT_TREE_DIFFERS, f"{count} of {tree.numel()} gradient entries differ"
    assert float((tree - fold).abs().max()) <= 1e-5 * float(fold.abs().max())

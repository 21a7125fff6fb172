"""The winner recompute's plain versions and its autograd Function on the CPU.

`cuda_recompute.recompute_adjoint_reference` is the explicit reverse sweep
of the recompute that csrc/recompute.cu's backward kernel evaluates, and the
plain version the kernel is held against on the card.  Here it is held
against the two gradients it stands for, on the same inputs (the JAX
package's lenses carried over by `convert.patches_from_numpy`, rays and
cotangents made from a NumPy seed):

(a) torch's autograd of the twin `recompute_reference`, on every table
    column and on start and direction, at atol 1e-5 x max|g| and rtol 1e-4,
    at most 5e-4 of the entries outside and none beyond rtol 1e-3.  The
    sweep takes each op back as autograd does (its formulas, the order in
    which it adds each gradient's terms), and on the CPU the two are bit
    for bit the same, which `test_adjoint_is_autograd_bit_for_bit` holds;
(b) `jax.vjp` of the JAX package's `recompute_winner`, run op by op
    (`jax.disable_jit()`), at the bar of tests/test_torch_lens_model.py's
    gradient test: rtol 1e-3, atol 1e-5 x max|g|, at most 5e-4 of the
    entries outside, none beyond rtol 5e-3, with cotangents on the hits;
    the inside and outside heights of patches with a ray at `abs`' kink
    are held apart (there each package's gradient takes the sign of a
    rounding error) and checked to be the twin's autograd;
(c) lanes at the non-smooth points, each finite and equal to autograd.

Then `_Recompute` with the plain versions in place of its launchers, the
routing of `intersect.recompute_winner`, and the kernels' source compiled
for the host (`test_kernel_source_on_the_host`).
"""
import ctypes
import inspect
import os
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbtr_tpu.bezier import build_from_trimesh as jax_build
from cbtr_tpu.harness.measure import preprocess as jax_preprocess
from cbtr_tpu.mesh.core import make_unit_sphere as jax_sphere
from cbtr_tpu.models import scenes as jax_scenes
from cbtr_tpu.ops import intersect as jix

from cbtr_tpu_torch.convert import patches_from_numpy
from cbtr_tpu_torch.ops import cuda_lib
from cbtr_tpu_torch.ops import cuda_recompute as cr
from cbtr_tpu_torch.ops import cuda_segment as sg
from cbtr_tpu_torch.ops import cuda_sweep as cs
from cbtr_tpu_torch.ops import intersect as ix

torch.set_num_threads(2)

FIELDS = ("distance", "point", "normal", "bary", "cos_incidence")
# the packed table's float leaves by column (BezierPatches.packed_f32)
LEAF_COLUMNS = (("control_points", 0, 30), ("underlying", 30, 34), ("bary_inverse", 34, 43),
                ("heights", 43, 45), ("deriv_b", 45, 48), ("dividers", 48, 60))


def _fan(n, seed):
    rng = np.random.default_rng(seed)
    start = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    start[:, 0] -= 3.0
    target = rng.normal(size=(n, 3)).astype(np.float32) * 0.4
    d = target - start
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return start, d


def _case(jax_patches, start, direction):
    port = patches_from_numpy({k: np.asarray(v) for k, v in jax_patches._asdict().items()},
                              device="cpu")
    s, d = torch.tensor(np.asarray(start)), torch.tensor(np.asarray(direction))
    any_hit, win, _ = cs.sweep_select(port, s, d)
    return dict(jax=jax_patches, port=port, start=s, direction=d, any_hit=any_hit, win=win,
                idx=win.clamp_min(0).to(torch.int64))


@pytest.fixture(scope="module")
def cases():
    """The robot lens (P = 450) at 32^2 rays and the sphere 7 x 3 with a fan
    of 1,024 hand-built rays, both built by the JAX package."""
    sphere = jax_build(jax_preprocess(jax_sphere(7, 3), use_native=False))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CBTR_NATIVE", "0")
        robot = jax_scenes.robot_lens_scene(res=32)
    return {"robot": _case(robot.patches, robot.start, robot.direction),
            "sphere": _case(sphere, *_fan(1024, 3))}


def _cotangents(R, seed=0):
    """Random cotangents of the five differentiable fields, on every ray."""
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(shape).astype(np.float32))
            for shape in ((R,), (R, 3), (R, 3), (R, 3), (R,))]


def _autograd(table, idx, start, direction, any_hit, win, cot, recompute=None):
    """Autograd of the recompute (the twin by default) against the
    cotangents: (table gradient, start gradient, direction gradient)."""
    table = table.detach().clone().requires_grad_(True)
    s = start.detach().clone().requires_grad_(True)
    d = direction.detach().clone().requires_grad_(True)
    hit, _ = (recompute or cr.recompute_reference)(table, idx, s, d, any_hit, win)
    sum(((torch.where(any_hit, hit.distance, 0.0) if f == "distance" else getattr(hit, f)) * c
         ).sum() for f, c in zip(FIELDS, cot)).backward()
    return table.grad, s.grad, d.grad


def _adjoint(table, idx, start, direction, any_hit, cot):
    """The plain backward: (table gradient, start gradient, direction
    gradient), the rows added into the table by the segment sum."""
    rows, g_s, g_d = cr.recompute_adjoint_reference(table, idx, start, direction, any_hit,
                                                    *cot)
    return sg.segment_sum_reference(idx, rows, table.shape[0]), g_s, g_d


def _counts(got, want):
    """(entries, outside rtol 1e-3, beyond rtol 5e-3) at atol 1e-5 x max|want|:
    what queue C of ROADMAP.md records."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = 1e-5 * np.abs(want).max()
    return (got.size, int((~np.isclose(got, want, rtol=1e-3, atol=atol)).sum()),
            int((~np.isclose(got, want, rtol=5e-3, atol=atol)).sum()))


def _within(got, want, rtol, rtol_max, frac=5e-4):
    """got within (atol 1e-5 x max|want|, rtol): at most `frac` of the
    entries outside, none beyond rtol_max."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = 1e-5 * np.abs(want).max()
    assert atol > 0
    outside = ~np.isclose(got, want, rtol=rtol, atol=atol)
    assert outside.mean() <= frac, np.argwhere(outside)[:10]
    np.testing.assert_allclose(got, want, rtol=rtol_max, atol=atol)


@pytest.mark.parametrize("case", ["robot", "sphere"])
def test_adjoint_against_autograd(cases, case):
    """(a): every table column and start/direction against autograd of the
    twin, random cotangents on all five fields of every ray (misses too)."""
    c = cases[case]
    table = c["port"].packed_f32()
    cot = _cotangents(c["start"].shape[0])
    want = _autograd(table, c["idx"], c["start"], c["direction"], c["any_hit"], c["win"], cot)
    got = _adjoint(table, c["idx"], c["start"], c["direction"], c["any_hit"], cot)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _within(g, w, 1e-4, 1e-3)
    assert int(c["any_hit"].sum()) > 100 and bool((~c["any_hit"]).any())


@pytest.mark.parametrize("case", ["robot", "sphere"])
def test_adjoint_is_autograd_bit_for_bit(cases, case):
    """The sweep adds each gradient's terms in the order autograd adds them,
    with autograd's formulas: on the CPU the row gradients and the ray
    gradients are autograd's, bit for bit (the kernel, on the card, is the
    sweep's)."""
    c = cases[case]
    table = c["port"].packed_f32()
    R = c["start"].shape[0]
    cot = _cotangents(R, seed=1)
    rows = table[c["idx"]].detach().clone().requires_grad_(True)
    s = c["start"].clone().requires_grad_(True)
    d = c["direction"].clone().requires_grad_(True)
    hit, _ = cr.recompute_reference(rows, torch.arange(R), s, d, c["any_hit"], c["win"])
    sum(((torch.where(c["any_hit"], hit.distance, 0.0) if f == "distance"
          else getattr(hit, f)) * g).sum() for f, g in zip(FIELDS, cot)).backward()
    got = cr.recompute_adjoint_reference(table, c["idx"], c["start"], c["direction"],
                                         c["any_hit"], *cot)
    assert torch.equal(got[0], rows.grad)
    assert torch.equal(got[1], s.grad) and torch.equal(got[2], d.grad)
    assert not got[0][:, 48:].any()      # the dividers decide only `what`


def _jax_vjp(c, cot):
    """jax.vjp of the JAX package's recompute_winner, op by op, against the
    cotangents: (the packed table's gradient [P, 60], start's, direction's)."""
    jp = c["jax"]
    floats = {k: v for k, v in jp._asdict().items() if k != "neighbours"}
    any_hit, win = jnp.asarray(c["any_hit"].numpy()), jnp.asarray(c["win"].numpy())

    def fields(leaves, start, direction):
        hit = jix.recompute_winner(jp._replace(**leaves), start, direction, any_hit, win)
        return (jnp.where(any_hit, hit.distance, 0.0), hit.point, hit.normal, hit.bary,
                hit.cos_incidence)

    with jax.disable_jit():
        _, vjp = jax.vjp(fields, floats, jnp.asarray(c["start"].numpy()),
                         jnp.asarray(c["direction"].numpy()))
        g_leaves, g_s, g_d = vjp(tuple(jnp.asarray(x.numpy()) for x in cot))
    P = c["port"].num_patches
    table = np.concatenate([np.asarray(g_leaves[name]).reshape(P, hi - lo)
                            for name, lo, hi in LEAF_COLUMNS], axis=1)
    return table, np.asarray(g_s), np.asarray(g_d)


def _kink_patches(c):
    """Patches with a hit ray whose bracket end lies on the plane (|plane
    distance| <= 1e-6 t): there `abs`' gradient takes the sign of a rounding
    error, which torch and XLA round apart (a patch of zero inside or
    outside height puts the bracket end at the plane hit)."""
    table = c["port"].packed_f32().detach()
    row, s, d, (br, _, _) = _lane_state(table, c["idx"], c["start"], c["direction"])
    kink = torch.zeros_like(c["any_hit"])
    for t in (br["closer"], br["further"]):
        kink |= cr._surface_diff(row, s, d, t)[1].abs() <= 1e-6 * t.abs()
    return torch.unique(c["idx"][kink & c["any_hit"]])


@pytest.mark.parametrize("case", ["robot", "sphere"])
def test_adjoint_against_jax_vjp(cases, case):
    """(b): the table, start and direction gradients against jax.vjp of the
    JAX recompute on the same lens, rays, winners and random cotangents on
    the hit rays (a miss's fields carry none on every path: `refract_rays`
    keeps a miss's ray; (a) and (c) hold the misses to autograd).  The
    heights' columns of patches with a ray at abs' kink are held apart:
    there the two packages' gradients take the signs of rounding errors, and
    the port's is its twin's autograd, bit for bit (ROADMAP queue C counts
    the entries beyond the bar)."""
    c = cases[case]
    hit = c["any_hit"]
    cot = [torch.where(hit if x.dim() == 1 else hit[:, None], x, 0.0)
           for x in _cotangents(c["start"].shape[0], seed=2)]
    want = _jax_vjp(c, cot)
    table = c["port"].packed_f32()
    got = _adjoint(table, c["idx"], c["start"], c["direction"], hit, cot)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
    kink = torch.zeros(table.shape, dtype=torch.bool)
    kink[_kink_patches(c), 43:45] = True
    assert int(kink.sum()) > 0
    _within(np.where(kink, want[0], got[0].numpy()), want[0], 1e-3, 5e-3)
    for g, w in zip(got[1:], want[1:]):
        _within(g.numpy(), w, 1e-3, 5e-3)
    twin = _autograd(table, c["idx"], c["start"], c["direction"], hit, c["win"], cot)[0]
    assert torch.equal(got[0][kink], twin[kink])
    # the counts queue C records (pytest -s prints them): these cotangents,
    # then random cotangents on every ray (the misses' rows too)
    every = _cotangents(c["start"].shape[0], seed=2)
    got_every = _adjoint(table, c["idx"], c["start"], c["direction"], hit, every)
    for label, g, w in (("hits", got, want), ("every ray", got_every, _jax_vjp(c, every))):
        print(f"{case}, cotangents on {label}: (entries, outside rtol 1e-3, beyond 5e-3) "
              f"table {_counts(g[0], w[0])}, of it the kink heights "
              f"{_counts(g[0].numpy()[kink.numpy()], w[0][kink.numpy()])}, start "
              f"{_counts(g[1], w[1])}, direction {_counts(g[2], w[2])}")


# ---------------------------------------------------------------------------
# (c) the non-smooth points
# ---------------------------------------------------------------------------


def _lane_state(table, idx, start, direction):
    """The plain forward's intermediates, for picking lanes."""
    row = table.detach()[idx]
    s = tuple(start[:, x] for x in range(3))
    d = tuple(direction[:, x] for x in range(3))
    return row, s, d, cr._forward_state(row, s, d)


def _check_lanes(table, idx, start, direction, any_hit, win, lanes):
    """The adjoint on the chosen lanes: finite and autograd's, bit for bit."""
    assert lanes.numel() > 0
    args = (idx[lanes], start[lanes], direction[lanes], any_hit[lanes], win[lanes])
    cot = _cotangents(lanes.numel(), seed=3)
    want = _autograd(table, *args, cot)
    got = _adjoint(table, args[0], args[1], args[2], args[3], cot)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert torch.equal(g, w)


def test_edge_lane_misses(cases):
    """Rays that hit nothing, their win -1 clamped to patch 0 (as
    `recompute_winner` clamps it)."""
    c = cases["robot"]
    misses = torch.nonzero(~c["any_hit"]).flatten()
    win = torch.where(c["any_hit"], c["win"], -1)
    _check_lanes(c["port"].packed_f32(), win.clamp_min(0).to(torch.int64), c["start"],
                 c["direction"], c["any_hit"], win, misses)


def test_edge_lane_bary_clamp_binds(cases):
    """Lanes whose bary leaves [-16, 16] in the bracket or in an iteration:
    the clamp passes nothing there."""
    c = cases["robot"]
    table = c["port"].packed_f32()
    row, s, d, (br, inputs, _) = _lane_state(table, c["idx"], c["start"], c["direction"])
    binds = torch.zeros_like(c["any_hit"])
    for m, pd in inputs:
        braw = cr._newton(row, s, d, m, pd)["braw"]
        binds |= torch.stack(braw).abs().gt(16.0).any(dim=0)
    for t in (br["closer"], br["further"]):
        binds |= torch.stack(cr._surface_diff(row, s, d, t)[3]).abs().gt(16.0).any(dim=0)
    _check_lanes(table, c["idx"], c["start"], c["direction"], c["any_hit"], c["win"],
                 torch.nonzero(binds).flatten())


def test_edge_lane_secant_clip_binds(cases):
    """Lanes whose secant estimate lies outside [closer, further]: the clip's
    bound takes the gradient."""
    c = cases["robot"]
    table = c["port"].packed_f32()
    _, _, _, (br, _, _) = _lane_state(table, c["idx"], c["start"], c["direction"])
    lo = torch.minimum(br["closer"], br["further"])
    hi = torch.maximum(br["closer"], br["further"])
    binds = (br["mraw"] < lo) | (br["mraw"] > hi)
    _check_lanes(table, c["idx"], c["start"], c["direction"], c["any_hit"], c["win"],
                 torch.nonzero(binds).flatten())


def _flat_rows(c, lanes, heights):
    """The table with the lanes' winners' heights set, and those lanes."""
    table = c["port"].packed_f32().detach().clone()
    table[c["idx"][lanes], 43:45] = torch.tensor(heights)
    return table


def test_edge_lane_clip_ties_and_midpoint_fallback(cases):
    """Hit lanes on patches of zero height: closer == further, so the
    secant's denominator vanishes (the midpoint fallback), the midpoint is
    the bracket's one point and every min / max of the clip ties (torch
    splits the gradient in half)."""
    c = cases["robot"]
    hits = torch.nonzero(c["any_hit"]).flatten()[:64]
    table = _flat_rows(c, hits, [0.0, 0.0])
    _, _, _, (br, _, _) = _lane_state(table, c["idx"][hits], c["start"][hits],
                                      c["direction"][hits])
    assert bool(br["fallback"].all()) and torch.equal(br["closer"], br["further"])
    assert torch.equal(br["mraw"], br["closer"])
    _check_lanes(table, c["idx"], c["start"], c["direction"], c["any_hit"], c["win"], hits)


def test_edge_lane_vanished_step():
    """A patch whose control net is all zero, on the plane x = 0, and rays
    along the x axis: the plane point is the origin, which is the surface
    point, so the Newton step is 0 (the direction is kept), the normal is
    below safe_normalize's epsilon (0) and the Newton denominator d . normal
    is clamped."""
    table = torch.zeros((1, 60))
    table[0, 30:34] = torch.tensor([1.0, 0.0, 0.0, 0.0])          # plane x = 0
    table[0, 34:43] = torch.eye(3).reshape(9)                    # bary = p
    table[0, 43:45] = torch.tensor([-0.1, 0.1])
    table[0, 45:48] = torch.tensor([0.0, 1.0, -1.0])
    rng = np.random.default_rng(4)
    R = 16
    start = torch.tensor(np.c_[-rng.uniform(0.5, 2.0, R), np.zeros((R, 2))].astype(np.float32))
    direction = torch.tensor(np.tile([1.0, 0.0, 0.0], (R, 1)).astype(np.float32))
    idx = torch.zeros(R, dtype=torch.int64)
    any_hit = torch.ones(R, dtype=torch.bool)
    win = torch.zeros(R, dtype=torch.int32)
    row, s, d, (_, inputs, last) = _lane_state(table, idx, start, direction)
    assert not bool(last["moved"].any()) and not bool(torch.stack(last["nm"]).any())
    assert bool((last["mden"].abs() < 1e-12).all())
    _check_lanes(table, idx, start, direction, any_hit, win, torch.arange(R))


# ---------------------------------------------------------------------------
# (d) _Recompute with the plain versions as its launchers
# ---------------------------------------------------------------------------


@pytest.fixture
def plain_launchers(monkeypatch):
    """`_Recompute` on CPU tensors: the plain forward and backward in place of
    the kernels' launchers, and the kernel route (`on_kernels`) taken on
    backend "auto" as for CUDA tensors."""
    monkeypatch.setattr(cr, "launch_forward", cr.recompute_forward_reference)
    monkeypatch.setattr(cr, "launch_backward", cr.recompute_adjoint_reference)
    monkeypatch.setattr(cr, "on_kernels", lambda table, backend="auto": backend == "auto")


def _kernels_with_ids(table, idx, start, direction, any_hit, win):
    """`recompute_kernels` in `_autograd`'s signature: the Function takes its
    ids from `win` (idx is `winner_ids(win)` in every caller here)."""
    assert torch.equal(idx, cr.winner_ids(win))
    return cr.recompute_kernels(table, start, direction, any_hit, win)


def test_function_gradients_are_the_adjoint(cases, plain_launchers):
    """The Function's forward is the twin's and its gradients are the
    adjoint's (rows added into the table by the segment sum)."""
    c = cases["robot"]
    table = c["port"].packed_f32()
    args = (c["idx"], c["start"], c["direction"], c["any_hit"], c["win"])
    cot = _cotangents(c["start"].shape[0], seed=5)
    hit, what_w = _kernels_with_ids(table, *args)
    want_hit, want_what = cr.recompute_reference(table, *args)
    assert all(torch.equal(a, b) for a, b in zip(hit, want_hit))
    assert torch.equal(what_w, want_what)
    got = _autograd(table, *args, cot, recompute=_kernels_with_ids)
    want = _adjoint(table, c["idx"], c["start"], c["direction"], c["any_hit"], cot)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_function_keeps_the_int32_winners(cases, plain_launchers):
    """Between its forward and its backward the Function holds its inputs
    and, of the ids, the int32 winners (4 bytes a ray, what a chunk's
    checkpoint held), not the int64 ids: with no checkpoint on the kernel
    route, a 4K step keeps 64 chunks' worth of them."""
    c = cases["robot"]
    table = c["port"].packed_f32().detach().requires_grad_(True)
    hit, _ = cr.recompute_kernels(table, c["start"], c["direction"], c["any_hit"], c["win"])
    saved = hit.point.grad_fn.saved_tensors
    assert [t.dtype for t in saved] == [torch.float32, torch.float32, torch.float32,
                                        torch.bool, torch.int32]
    assert torch.equal(saved[4], c["win"])
    assert saved[0].data_ptr() == table.data_ptr()      # the table's own numbers


def test_function_takes_its_ids_from_win(cases, plain_launchers, monkeypatch):
    """The Function has no ids of its own to disagree with its winners: its
    forward and its backward both read the rows `winner_ids(win)` (a miss's
    -1 on row 0), and `recompute` takes no ids."""
    c = cases["robot"]
    seen = []

    def forward(table, idx, *rest):
        seen.append(("forward", idx))
        return cr.recompute_forward_reference(table, idx, *rest)

    def backward(table, idx, *rest):
        seen.append(("backward", idx))
        return cr.recompute_adjoint_reference(table, idx, *rest)

    monkeypatch.setattr(cr, "launch_forward", forward)
    monkeypatch.setattr(cr, "launch_backward", backward)
    win = torch.where(c["any_hit"], c["win"], -1)
    assert bool((win < 0).any())
    cot = _cotangents(win.shape[0], seed=8)
    got = _autograd(c["port"].packed_f32(), cr.winner_ids(win), c["start"], c["direction"],
                    c["any_hit"], win, cot, recompute=_kernels_with_ids)
    want = _adjoint(c["port"].packed_f32(), cr.winner_ids(win), c["start"], c["direction"],
                    c["any_hit"], cot)
    assert [kind for kind, _ in seen] == ["forward", "backward"]
    assert all(torch.equal(idx, cr.winner_ids(win)) for _, idx in seen)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for f in (cr.recompute, cr.recompute_kernels):
        assert "idx" not in inspect.signature(f).parameters


def test_function_values_are_the_tables_shape(cases, plain_launchers):
    """The numbers a caller packs once for many chunks must be a table of
    the table's shape."""
    c = cases["robot"]
    table = c["port"].packed_f32()
    with pytest.raises(ValueError, match="table's numbers"):
        cr.recompute_kernels(table, c["start"], c["direction"], c["any_hit"], c["win"],
                             values=table[:-1])


def _leaf_grads(port, start, direction, chunk, backend="auto"):
    """Gradients of every float leaf and of the rays through intersect_rays
    (chunked: each chunk's recompute under checkpoint, or on the kernel
    route called directly)."""
    leaves = {k: v.detach().clone().requires_grad_(k != "neighbours")
              for k, v in port.leaves().items()}
    patches = type(port)(**leaves)
    s = start.clone().requires_grad_(True)
    d = direction.clone().requires_grad_(True)
    hit = ix.intersect_rays(patches, s, d, chunk_size=chunk, backend=backend)
    ok = hit.what == ix.WHAT_INTERSECT
    cot = _cotangents(s.shape[0], seed=6)
    sum(((torch.where(ok, getattr(hit, f), 0.0) if g.dim() == 1
          else torch.where(ok[:, None], getattr(hit, f), 0.0)) * g).sum()
        for f, g in zip(FIELDS, cot)).backward()
    grads = {k: v.grad for k, v in leaves.items() if k != "neighbours"}
    return grads, s.grad, d.grad


def test_checkpointed_chunks_match_one_chunk(cases, plain_launchers, monkeypatch):
    """intersect_rays in chunks of 256 (each recompute under checkpoint,
    re-run in the backward: the plain route) gives the gradients of one
    chunk; the table's sum over the chunks is associated otherwise, the
    rays' are equal."""
    c = cases["robot"]
    monkeypatch.setattr(cr, "on_kernels", lambda table, backend="auto": False)
    one, s1, d1 = _leaf_grads(c["port"], c["start"], c["direction"], 0)
    chunked, s4, d4 = _leaf_grads(c["port"], c["start"], c["direction"], 256)
    assert torch.equal(s1, s4) and torch.equal(d1, d4)
    for k in one:
        torch.testing.assert_close(chunked[k], one[k], rtol=1e-5,
                                   atol=1e-6 * float(one[k].abs().max()))


def test_kernel_route_needs_no_checkpoint(cases, plain_launchers, monkeypatch):
    """intersect_rays in chunks of 256 on the kernel route (the route switch
    `cuda_recompute.on_kernels` set, as for CUDA patches) calls each chunk's
    recompute directly: the forward launches once a chunk, not again in the
    backward, and every leaf and ray gradient is the checkpointed run's (the
    plain route, its forward run twice a chunk), bit for bit."""
    c = cases["robot"]
    launches, plain = [], []

    def counted(*args):
        launches.append(args[1].shape[0])
        return cr.recompute_forward_reference(*args)

    def counted_plain(table, idx, *rest):
        plain.append(idx.shape[0])
        return reference(table, idx, *rest)

    reference = cr.recompute_reference
    monkeypatch.setattr(cr, "launch_forward", counted)
    runs = {}
    for route in (False, True):
        monkeypatch.setattr(cr, "on_kernels", lambda table, backend="auto", r=route: r)
        monkeypatch.setattr(cr, "recompute_reference", reference if route else counted_plain)
        launches.clear()
        runs[route] = _leaf_grads(c["port"], c["start"], c["direction"], 256)
        runs[route] += (list(launches),)
    assert runs[True][3] == [256] * 4
    assert runs[False][3] == [] and plain == [256] * 8  # each checkpoint runs it again
    assert all(torch.equal(runs[True][0][k], runs[False][0][k]) for k in runs[False][0])
    assert torch.equal(runs[True][1], runs[False][1])
    assert torch.equal(runs[True][2], runs[False][2])


def test_kernel_route_holds_one_packing(cases, plain_launchers):
    """On the kernel route every chunk's Function keeps the numbers of one
    packing of the table, made once for the call, not a packing a chunk."""
    c = cases["robot"]
    leaves = {k: v.detach().clone().requires_grad_(k != "neighbours")
              for k, v in c["port"].leaves().items()}
    hit = ix.intersect_rays(type(c["port"])(**leaves), c["start"], c["direction"],
                            chunk_size=256)
    nodes, todo, seen = [], [hit.point.grad_fn], set()
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if "_Recompute" in type(node).__name__:
            nodes.append(node)
        todo.extend(n for n, _ in node.next_functions)
    assert len(nodes) == 4
    assert len({n.saved_tensors[0].data_ptr() for n in nodes}) == 1


def test_kernel_route_is_cuda_and_auto(cases):
    """The route switch: the kernels (no checkpoint) for CUDA tables on
    backend "auto" only."""
    table = cases["robot"]["port"].packed_f32().detach()
    assert not cr.on_kernels(table, "auto")
    assert not cr.on_kernels(table.to("meta"), "auto")
    cuda_looking = table.as_subclass(_CudaLooking)
    assert cr.on_kernels(cuda_looking, "auto")
    assert cr.on_kernels(cuda_looking)
    assert not cr.on_kernels(cuda_looking, "plain")


def test_design_gradient_reaches_every_leaf(cases, plain_launchers):
    """The design step differentiates every leaf through `build_patches`: the
    Function's gradient reaches the plane, the barycentric inverse, the
    heights and deriv_b (the dividers get 0), equal to the twin's."""
    c = cases["robot"]
    got, g_s, g_d = _leaf_grads(c["port"], c["start"], c["direction"], 0)
    want, w_s, w_d = _leaf_grads(c["port"], c["start"], c["direction"], 0, backend="plain")
    for k in ("control_points", "underlying", "bary_inverse", "heights", "deriv_b"):
        assert torch.isfinite(got[k]).all() and bool(got[k].abs().sum() > 0), k
        assert torch.equal(got[k], want[k]), k
    assert not got["dividers"].any()
    assert torch.equal(g_s, w_s) and torch.equal(g_d, w_d)


# ---------------------------------------------------------------------------
# (e) routing
# ---------------------------------------------------------------------------


def _banned(*args, **kwargs):
    raise AssertionError("a kernel launcher was called")


def test_cpu_tensors_run_the_twin(cases, monkeypatch):
    """CPU tensors never reach the launchers; backend "plain" never reaches
    the kernel path on any device."""
    c = cases["robot"]
    monkeypatch.setattr(cr, "launch_forward", _banned)
    monkeypatch.setattr(cr, "launch_backward", _banned)
    args = (c["port"], c["start"], c["direction"], c["any_hit"], c["win"])
    hit = ix.recompute_winner(*args)
    want, _ = cr.recompute_reference(c["port"].packed_f32(), c["idx"], *args[1:])
    assert all(torch.equal(a, b) for a, b in zip(hit, want))
    monkeypatch.setattr(cr, "recompute_kernels", _banned)
    plain, rejects = ix.recompute_winner(*args, with_check=True, backend="plain")
    assert all(torch.equal(a, b) for a, b in zip(plain, want)) and rejects == 0
    with pytest.raises(ValueError, match="backend"):
        ix.recompute_winner(*args, backend="xla")


class _CudaLooking(torch.Tensor):
    """A CPU tensor that says it lies on the card."""

    @property
    def is_cuda(self):
        return True


def test_cuda_tensors_never_reach_the_twin(cases, monkeypatch):
    """A table on the card goes to the kernels: when the launcher fails, the
    recompute raises, and the twin is not run."""
    c = cases["robot"]
    monkeypatch.setattr(cr, "recompute_reference", _banned)
    table = c["port"].packed_f32().detach().as_subclass(_CudaLooking)
    args = (c["start"], c["direction"], c["any_hit"], c["win"])
    # the real launcher refuses tensors that are not on a CUDA device
    with pytest.raises(ValueError, match="CUDA tensors"):
        cr.recompute(table, *args)

    def failed_build(*a, **k):
        raise RuntimeError("nvcc failed on csrc/recompute.cu")

    monkeypatch.setattr(cr, "launch_forward", failed_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cr.recompute(table, *args)


def test_launchers_check_their_inputs(cases):
    """The launchers refuse what the kernels do not take, before any build."""
    c = cases["robot"]
    table = c["port"].packed_f32().detach()
    args = [c["idx"], c["start"], c["direction"], c["any_hit"], c["win"]]
    with pytest.raises(ValueError, match="CUDA tensors"):
        cr.launch_forward(table, *args)
    bad = dict(zip(("idx", "start", "direction", "any_hit", "win"), args))
    bad["idx"] = c["win"]
    with pytest.raises(ValueError):
        cr._check(table.to("meta"), *(v.to("meta") for v in bad.values()))


# ---------------------------------------------------------------------------
# the kernels' source, compiled for the host
# ---------------------------------------------------------------------------

# what the CUDA source needs from the CUDA headers, for a host compiler: a
# block's index and its threads' are plain variables that the loops below
# set, and shared memory is static
_HOST_HEADER = r"""
#pragma once
#include <cmath>
#include <cstddef>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
template <class T> inline T __ldg(const T* p) { return *p; }
struct HostIndex { unsigned x; };
static HostIndex threadIdx, blockIdx;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes, sharedSizeBytes; };
template <class F> inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes*, F) {
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, F, int, size_t) {
  return cudaSuccess;
}
"""
# the PTX max/min with NaN propagation, in C
_HOST_MINMAX = {
    'asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));':
        "m = (a != a || b != b) ? NAN : (a > b ? a : (b > a ? b : (std::signbit(a) ? b : a)));",
    'asm("min.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));':
        "m = (a != a || b != b) ? NAN : (a < b ? a : (b < a ? b : (std::signbit(a) ? a : b)));",
}
_KERNEL = re.compile(r"__global__ void __launch_bounds__\((\w+), \w+\)\s+(\w+)\([^)]*\) \{\n")
_LAUNCH = re.compile(r"(\w+)<<<(\w+), [^;]*?>>>")


def _closing_brace(src, start):
    """The index of the brace that closes the one just before `start`."""
    depth = 1
    for k in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[k], 0)
        if depth == 0:
            return k
    raise AssertionError("unbalanced braces")


def _statements(body):
    """A kernel body's statements, split at the semicolons outside braces and
    parentheses."""
    out, depth, start = [], 0, 0
    for k, ch in enumerate(body):
        depth += {"{": 1, "(": 1, "}": -1, ")": -1}.get(ch, 0)
        if ch == ";" and depth == 0:
            out.append(body[start:k + 1])
            start = k + 1
    assert not body[start:].strip(), body[start:]
    return out


def _host_blocks(src):
    """The kernels' source with each block run on the host: every launch a
    loop over its blocks (blockIdx.x), every kernel a loop over the block's
    threads (threadIdx.x) for each phase between __syncthreads() calls, its
    leading declarations (its shared arrays, static here, and its view of
    the parameters) once before them.  A phase shares nothing with the next
    but those, as on the card."""
    src, launches = _LAUNCH.subn(
        r"for (blockIdx.x = 0; blockIdx.x < static_cast<unsigned>(\2); ++blockIdx.x) \1", src)
    assert launches == 2, launches
    kernels, pos = [], 0
    while (m := _KERNEL.search(src, pos)) is not None:
        end = _closing_brace(src, m.end())
        statements = _statements(src[m.end():end])
        block = []
        while statements and statements[0].strip().startswith(("__shared__", "const ")):
            block.append(statements.pop(0))
        phases = [[]]
        for st in statements:
            if st.strip() == "__syncthreads();":
                phases.append([])
            else:
                phases[-1].append(st)
        loops = "".join(f"\n  for (threadIdx.x = 0; threadIdx.x < {m.group(1)}; ++threadIdx.x) "
                        f"{{{''.join(phase)}\n  }}" for phase in phases)
        src = src[:m.end()] + "".join(block) + loops + "\n" + src[end:]
        kernels.append((m.group(2), len(phases)))
        pos = m.end()
    assert kernels == [("recompute_forward_kernel", 1), ("recompute_backward_kernel", 2)], kernels
    return src


def _host_build(tmp_path):
    """csrc/recompute.cu built with g++ (no contraction) for the host: each
    entry point runs its kernel block by block (`_host_blocks`)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' source for the host")
    csrc = os.path.join(os.path.dirname(cr.__file__), os.pardir, "csrc")
    header = open(os.path.join(csrc, "candidate.cuh")).read()
    for ptx, c in _HOST_MINMAX.items():
        assert ptx in header
        header = header.replace(ptx, c)
    src = _host_blocks(open(os.path.join(csrc, "recompute.cu")).read())
    (tmp_path / "cuda_runtime.h").write_text(_HOST_HEADER)
    (tmp_path / "candidate.cuh").write_text(header)
    (tmp_path / "recompute.cpp").write_text(src)
    lib = tmp_path / "librecompute_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fno-fast-math", "-shared",
                    "-fPIC", "-Wno-unknown-pragmas", f"-I{tmp_path}",
                    "-o", str(lib), str(tmp_path / "recompute.cpp")], check=True,
                   capture_output=True, timeout=600)
    out = ctypes.CDLL(str(lib))
    out.cbtr_recompute.argtypes = cr._FORWARD_ARGTYPES
    out.cbtr_recompute_backward.argtypes = cr._BACKWARD_ARGTYPES
    return out


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    """The kernels' source built for the host."""
    return _host_build(tmp_path_factory.mktemp("recompute_host"))


def _host_cases(cases):
    """The fixtures' cases, and the robot's first 1,000 rays: 7 blocks of 128
    and a ragged last block of 104."""
    c = cases["robot"]
    ragged = dict(c, **{k: c[k][:1000] for k in ("start", "direction", "any_hit", "win", "idx")})
    return {**cases, "robot, 1,000 rays": ragged}


@pytest.mark.parametrize("iters", [1, 4, 8])
def test_kernel_source_on_the_host(cases, host_library, monkeypatch, iters):
    """The kernels' arithmetic, compiled for the host with g++ and run block
    by block, is the plain versions' bit for bit: every forward field and
    the row, start and direction gradients, at 1, 4 (the config's) and 8
    Newton iterations (the kernels' loops bounded at run time, their
    iterations' inputs in a shared array sized for 8), on blocks of 128 rays
    and on a ragged last block.  The plain versions take what they
    take on the card: the correctly rounded square root (NumPy's; torch's
    CPU one is not always) and the card's order of a reduction's three
    terms."""
    with cr.newton_iterations(iters):
        assert cr._config()[0] == ix.CFG.root_search_iterations == iters
        _card_rounding(monkeypatch)
        _host_kernels_hold(cases, host_library)
    assert cr._config()[0] == ix.CFG.root_search_iterations == 4


def _host_kernels_hold(cases, host_library):
    """test_kernel_source_on_the_host's checks at the current Newton count."""
    for c in _host_cases(cases).values():
        _hold_to_the_plain_versions(host_library, c)
    # an id outside the table reads nothing: its fields and gradients are NaN
    # (the first and the last ray: the last block's last row)
    table = c["port"].packed_f32().detach().contiguous()
    s, d = c["start"].contiguous(), c["direction"].contiguous()
    R, P = s.shape[0], table.shape[0]
    bad = c["idx"].clone()
    bad[[0, -1]] = torch.tensor([-1, P])
    args = (table, bad, s, d, c["any_hit"], c["win"])
    out = tuple(torch.empty_like(f) for f in
                cr.recompute_forward_reference(table, c["idx"], *args[2:]))
    assert host_library.cbtr_recompute(*(t.data_ptr() for t in args),
                                       *(t.data_ptr() for t in out), P, R, *cr._config(),
                                       None) == 0
    assert all(bool(torch.isnan(f[[0, -1]]).all()) for f in out[1:6])
    assert bool((out[6][[0, -1]] == -1).all()) and bool((out[0][[0, -1]] == ix.WHAT_NONE).all())
    assert bool(torch.isfinite(out[2][1:-1]).all())
    cot = _cotangents(R, seed=7)
    want = cr.recompute_adjoint_reference(table, c["idx"], *args[2:5], *cot)
    grads = tuple(torch.empty_like(w) for w in want)
    assert host_library.cbtr_recompute_backward(*(t.data_ptr() for t in args[:5]),
                                                *(t.data_ptr() for t in cot),
                                                *(t.data_ptr() for t in grads), P, R,
                                                *cr._config(), None) == 0
    assert all(bool(torch.isnan(g[[0, -1]]).all()) for g in grads)
    assert all(torch.equal(g[1:-1], w[1:-1]) for g, w in zip(grads, want))


def _card_rounding(monkeypatch):
    """The plain versions with what they take on the card: the correctly
    rounded square root (NumPy's; torch's CPU one is not always) and the
    card's order of a reduction's three terms."""
    monkeypatch.setattr(torch, "sqrt", lambda t: torch.from_numpy(np.sqrt(t.numpy())))
    monkeypatch.setitem(cr._REDUCTION, "cpu", cr._REDUCTION["cuda"])


def _hold_to_the_plain_versions(lib, c):
    """The host-built kernels on case c: every forward field and the row,
    start and direction gradients `torch.equal` to the plain versions'."""
    table = c["port"].packed_f32().detach().contiguous()
    s, d = c["start"].contiguous(), c["direction"].contiguous()
    R, P = s.shape[0], table.shape[0]
    args = (table, c["idx"], s, d, c["any_hit"], c["win"])
    want = cr.recompute_forward_reference(*args)
    got = tuple(torch.empty_like(w) for w in want)
    assert lib.cbtr_recompute(*(t.data_ptr() for t in args), *(t.data_ptr() for t in got),
                              P, R, *cr._config(), None) == 0
    for name, g, w in zip(("what",) + FIELDS + ("patch", "what_w"), got, want):
        assert torch.equal(g, w), name
    cot = _cotangents(R, seed=7)
    want = cr.recompute_adjoint_reference(*args[:5], *cot)
    got = tuple(torch.empty_like(w) for w in want)
    assert lib.cbtr_recompute_backward(*(t.data_ptr() for t in args[:5]),
                                       *(t.data_ptr() for t in cot),
                                       *(t.data_ptr() for t in got), P, R,
                                       *cr._config(), None) == 0
    for name, g, w in zip(("rows", "start", "direction"), got, want):
        assert torch.equal(g, w), name


_RECOMPUTE_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124recompute_forward_kernelEPKfPKx' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_124recompute_forward_kernelEPKfPKx
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 4608 bytes smem, 464 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125recompute_backward_kernelEPKfPKx' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_125recompute_backward_kernelEPKfPKx
    144 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 168 registers, 464 bytes cmem[0]
"""

# K1's and K2's instantiations (the mode, and K1's half_gate, in the mangled
# name), at global scope and in an anonymous namespace as csrc/ declares
# them, and a device function, which has no registers of its own
_SWEEP_LOG = """== sweep_select.cu
ptxas info    : 0 bytes gmem
ptxas info    : Function properties for _ZN12_GLOBAL__N_18cull_tileEPKfi
    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_Z19sweep_select_kernelILi1ELb1EEvPKfS1_S1_PKiPfPiS5_S5_S5_iiiiiiffffi' for 'sm_90a'
ptxas info    : Function properties for _Z19sweep_select_kernelILi1ELb1EEvPKfS1_S1_PKiPfPiS5_S5_S5_iiiiiiffffi
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 39936 bytes smem, 464 bytes cmem[0]
ptxas info    : Compiling entry function '_Z19sweep_select_kernelILi0ELb0EEvPKfS1_S1_PKiPfPiS5_S5_S5_iiiiiiffffi' for 'sm_90a'
ptxas info    : Function properties for _Z19sweep_select_kernelILi0ELb0EEvPKfS1_S1_PKiPfPiS5_S5_S5_iiiiiiffffi
    0 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 96 registers, 464 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119sweep_select_kernelILi2ELb0EEEvPKfS2_S2_PKiPfPiS6_S6_S6_iiiiiiffffi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119sweep_select_kernelILi2ELb0EEEvPKfS2_S2_PKiPfPiS6_S6_S6_iiiiiiffffi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 122 registers, 464 bytes cmem[0]
== winner.cu
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113winner_kernelILi0EEEvPKfS2_S2_PKiPfPiS6_S6_S6_iiiiiiffffi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113winner_kernelILi0EEEvPKfS2_S2_PKiPfPiS6_S6_S6_iiiiiiffffi
    4 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 110 registers, used 1 barriers, 1024 bytes smem, 464 bytes cmem[0]
ptxas info    : Compiling entry function '_Z13winner_kernelILi3EEvPKfS1_S1_PKiPfPiS5_S5_S5_iiiiiiffffi' for 'sm_90a'
ptxas info    : Function properties for _Z13winner_kernelILi3EEvPKfS1_S1_PKiPfPiS5_S5_S5_iiiiiiffffi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 2048 bytes smem, 464 bytes cmem[0]
"""


@pytest.mark.parametrize("log, want", [
    (_RECOMPUTE_LOG, {
        "recompute_forward_kernel": dict(stack=0, spill_stores=0, spill_loads=0,
                                         registers=64, shared_bytes=4608),
        "recompute_backward_kernel": dict(stack=144, spill_stores=4, spill_loads=8,
                                          registers=168, shared_bytes=0)}),
    (_SWEEP_LOG, {
        "sweep_select_kernel<1, true>": dict(stack=8, spill_stores=0, spill_loads=0,
                                             registers=128, shared_bytes=39936),
        "sweep_select_kernel<0, false>": dict(stack=0, spill_stores=12, spill_loads=16,
                                              registers=96, shared_bytes=0),
        "sweep_select_kernel<2, false>": dict(stack=0, spill_stores=0, spill_loads=0,
                                              registers=122, shared_bytes=0),
        "winner_kernel<3>": dict(stack=0, spill_stores=0, spill_loads=0, registers=80,
                                 shared_bytes=2048),
        "winner_kernel<0>": dict(stack=4, spill_stores=0, spill_loads=0, registers=110,
                                 shared_bytes=1024)}),
], ids=["recompute", "sweep"])
def test_ptxas_summary(log, want):
    """Phase 0 of chip_smoke reads each kernel's registers, stack, spills and
    shared memory from nvcc's -Xptxas -v output: the recompute pair by name,
    K1-K3 by instantiation."""
    assert cuda_lib.ptxas_summary(log) == want

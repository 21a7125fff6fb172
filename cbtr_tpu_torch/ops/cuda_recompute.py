"""The winner recompute on the GPU: its forward and backward kernels, their
wrappers, their plain PyTorch versions and the autograd Function built on
them.

The recompute re-evaluates each ray's winning patch, differentiably: the
gate-OFF candidate of `intersect._candidates_core` on the winner's row of
the packed [P, 60] float table (`BezierPatches.packed_f32`), giving the
`RayHit` fields.  In the JAX package it is XLA code
(cbtr_tpu/ops/intersect.py:314-350), which the compiler fuses into a few
device passes a chunk, and `jax.grad` differentiates through its 4
unrolled Newton iterations.  Run as eager torch ops (the plain versions
below) it is 1,084 device ops a call forward and 4,175 with its backward
and a loss on it, against 4 and 53 on the kernels (NVIDIA H100 80GB HBM3,
700.00 W; `harness/kernel_ab.py --recompute-only`): csrc/recompute.cu does
each direction in one launch.

* `recompute_reference` is the plain version of the forward: the row
  gather (`cuda_segment.gather_rows`) and `intersect.patch_candidates`
  under autograd.  `recompute_forward_reference` is the same without
  autograd, returning what the forward kernel writes.
* `recompute_adjoint_reference` is the plain version of the backward: the
  explicit reverse sweep of the same function, torch ops on [R] columns
  with no autograd.  From the cotangents of distance, point, normal, bary
  and cos_incidence it gives each ray's 60-column row gradient and the
  gradient of its start and direction.  It is the gradient of the unrolled
  iterations (what `jax.vjp` and torch's autograd of the twin compute, not
  the implicit-function gradient), and it takes every non-smooth point as
  torch defines it: `abs` passes 0 at 0, `clamp` passes on the closed
  interval, `minimum`/`maximum` split a tie in half, `safe_div`'s clamped
  denominator and `safe_normalize` below its epsilon pass nothing, a
  `where` passes to the branch it took.  It also adds each gradient's
  terms in autograd's order (the last use first, a broadcast's three terms
  in the device's reduction order, `_REDUCTION`), so it is torch's autograd
  of the twin bit for bit, on the CPU and on the card: the function is
  ill-conditioned on some lanes (an unconverged Newton iteration, the
  normal's cancelling quadratics), where another order of the same sums
  moves a gradient by up to 1e-2 relative.  The backward kernel evaluates
  the same expressions in the same order, so on the card the two are
  bit-equal.
* The table's gradient is the fixed-order `cuda_segment` sum of the row
  gradients by winner id, as `gather_rows`' backward was, so every path
  stays bit-reproducible between runs.

`recompute` is what `intersect.recompute_winner` calls: CPU tensors and
backend "plain" run `recompute_reference`; CUDA tensors on backend "auto"
(`on_kernels`) run `_Recompute`, whose forward and backward launch the
kernels (`launch_forward`, `launch_backward`) and raise if a build or
launch fails.  No path falls back from one to the other.  `COUNTED` holds
the launch counts: one a forward, one a backward.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import re

import torch
from torch.autograd.function import once_differentiable

from ..bezier.patches import BezierPatches
from ..config import DEFAULT as CFG
from ..utils.profiling import span
from . import cuda_segment

# columns of the packed table (BezierPatches.packed_f32): the control net
# 0..29 (point k, axis x at 3k + x), the plane normal 30..32 and constant 33,
# the barycentric inverse 34..42 (row-major), the heights 43 (inside) and 44
# (outside), deriv_b 45..47, the divider planes 48..59
N_COLS = 60
_N, _C, _M, _H_IN, _H_OUT, _DB = 30, 33, 34, 43, 44, 45
# the columns that carry a gradient: the dividers decide only `what`
N_GRAD = 48

_SAFE_DIV_EPS = 1e-12       # geom.safe_div
_NORMALIZE_EPS = 1e-30      # geom.safe_normalize
_BARY_CLAMP = 16.0          # the recompute's bary clamp
_MIDDLE_CLAMP = 1e7         # the Newton estimate's clamp
_MAX_ITERS = 8              # csrc/recompute.cu MAX_ITERS


# ---------------------------------------------------------------------------
# the plain forward (the twin)
# ---------------------------------------------------------------------------


def recompute_reference(table, idx, start, direction, any_hit, win):
    """Plain version of the recompute: (RayHit, gate-OFF what [R] i32).

    table [P, 60] (`BezierPatches.packed_f32`, under autograd); idx [R]
    int64 = win clamped to >= 0; start, direction [R, 3]; any_hit [R] bool,
    win [R] i32 from the winner search.  One [R, 60] gather of the winners'
    rows (its backward one fixed-order segment sum into the table), then
    `intersect.patch_candidates` with the domain gate off."""
    from . import intersect as ix

    rows = BezierPatches.from_packed_f32(
        cuda_segment.gather_rows(table, idx),
        torch.zeros(idx.shape + (3,), dtype=torch.int32, device=idx.device),
    )
    what_w, dist_w, pt, n, b, cos_w = ix.patch_candidates(rows, start, direction, False)
    hit = ix.RayHit(
        what=torch.where(any_hit, ix.WHAT_INTERSECT, ix.WHAT_NONE).to(torch.int32),
        distance=torch.where(any_hit, dist_w, ix._BIG),
        point=pt,
        normal=n,
        bary=b,
        cos_incidence=cos_w,
        patch=torch.where(any_hit, win, -1).to(torch.int32),
    )
    return hit, what_w


def recompute_forward_reference(table, idx, start, direction, any_hit, win):
    """What the forward kernel writes, by `recompute_reference` without
    autograd: (what, distance, point, normal, bary, cos_incidence, patch,
    gate-OFF what)."""
    with torch.no_grad():
        hit, what_w = recompute_reference(table, idx, start, direction, any_hit, win)
    return (*hit, what_w)


# ---------------------------------------------------------------------------
# the plain backward: the reverse sweep, column by column
# ---------------------------------------------------------------------------
#
# Every quantity below is an [R] tensor (one value a ray) and every vector a
# tuple of three; the functions mirror csrc/recompute.cu's device functions
# of the same names, expression for expression, so that the kernel rounds
# like them.  Products are commutative in IEEE arithmetic; sums are written
# left to right, in the kernel's order.


def _safe_den(den):
    """geom.safe_div's denominator: |den| clamped to 1e-12, sign kept."""
    eps = _SAFE_DIV_EPS
    return torch.where(den.abs() < eps, torch.where(den < 0, -eps, eps), den)


def _inv_norm(n2):
    """geom.safe_normalize's factor: 1 / sqrt(n2), or 0 below 1e-30."""
    eps = _NORMALIZE_EPS
    return torch.where(n2 < eps, 0.0, 1.0 / torch.sqrt(n2.clamp_min(eps)))


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


# the order in which autograd sums a broadcast operand's gradient over the
# three axes (`sum_to_size` of [R, 3] to [R, 1]), by device type: the CPU's
# reduction adds left to right, the card's adds the first and the third,
# then the second (both measured).  The reverse sweep sums those terms the
# same way, and the kernel in the card's order (csrc/recompute.cu `rsum3`)
_REDUCTION = {"cpu": "ab_c", "cuda": "ac_b"}


def _sum3(a, b, c):
    order = _REDUCTION[a.device.type]
    if order == "ab_c":
        return a + b + c
    if order == "ac_b":
        return a + c + b
    return a + (b + c)


def _rdot(a, b):
    """The gradient autograd sums for the [R, 1] operand of a broadcast
    product with [R, 3]: sum over the axes of a * b (`_REDUCTION`)."""
    return _sum3(a[0] * b[0], a[1] * b[1], a[2] * b[2])


def _cp(row, k, x):
    return row[:, 3 * k + x]


def _mat(row, i, j):
    return row[:, _M + 3 * i + j]


def _normal_of(row):
    return (row[:, _N], row[:, _N + 1], row[:, _N + 2])


def _apply_mat(row, v):
    """bary = M @ v, each row a left-to-right sum."""
    return tuple(_mat(row, i, 0) * v[0] + _mat(row, i, 1) * v[1] + _mat(row, i, 2) * v[2]
                 for i in range(3))


def _clamp_bary(b):
    return tuple(x.clamp(-_BARY_CLAMP, _BARY_CLAMP) for x in b)


def _weights(b):
    """The cubic Bernstein weights (bezier/patches.py `_bernstein`)."""
    b0, b1, b2 = b
    b0_2, b1_2, b2_2 = b0 * b0, b1 * b1, b2 * b2
    return (b0 * b0_2, b1 * b1_2, b2 * b2_2, 3.0 * b1 * b0_2, 3.0 * b0 * b1_2,
            3.0 * b2 * b1_2, 3.0 * b1 * b2_2, 3.0 * b0 * b2_2, 3.0 * b2 * b0_2,
            6.0 * b0 * b1 * b2)


def _interp(row, b):
    """The surface point at bary b (bezier/patches.py `interpolate`)."""
    w = _weights(b)
    out = []
    for x in range(3):
        f = w[0] * _cp(row, 0, x)
        for k in range(1, 10):
            f = f + w[k] * _cp(row, k, x)
        out.append(f)
    return tuple(out)


def _quadratics(b):
    """(b0^2, b1^2, b2^2, ab, bc, ac) of the normal's derivative components."""
    b0, b1, b2 = b
    return b0 * b0, b1 * b1, b2 * b2, 2.0 * b0 * b1, 2.0 * b1 * b2, 2.0 * b0 * b2


def _components(row, b):
    """The three quadratic components of bezier/patches.py `patch_normal`,
    each a 3-vector, in the reference's term order."""
    b0_2, b1_2, b2_2, ab, bc, ac = _quadratics(b)
    comp0, comp1, comp2 = [], [], []
    for x in range(3):
        def c(k):
            return _cp(row, k, x)
        comp0.append(b0_2 * c(0) + ab * c(3) + b1_2 * c(4) + b2_2 * c(7) + ac * c(8)
                     + bc * c(9))
        comp1.append(b1_2 * c(1) + b0_2 * c(3) + ab * c(4) + bc * c(5) + b2_2 * c(6)
                     + ac * c(9))
        comp2.append(b2_2 * c(2) + b1_2 * c(5) + bc * c(6) + ac * c(7) + b0_2 * c(8)
                     + ab * c(9))
    return comp0, comp1, comp2


def _normal_parts(row, b):
    """(comp0, comp1, comp2, A, B, v, n2, inv, normal): patch_normal's
    intermediates; v = A x B, normal = v * inv."""
    comp0, comp1, comp2 = _components(row, b)
    db = (row[:, _DB], row[:, _DB + 1], row[:, _DB + 2])
    A = tuple(comp0[x] - comp2[x] for x in range(3))
    B = tuple(db[0] * comp0[x] + db[1] * comp1[x] + db[2] * comp2[x] for x in range(3))
    v = (A[1] * B[2] - A[2] * B[1], A[2] * B[0] - A[0] * B[2], A[0] * B[1] - A[1] * B[0])
    n2 = _dot(v, v)
    inv = _inv_norm(n2)
    return comp0, comp1, comp2, A, B, v, n2, inv, tuple(v[x] * inv for x in range(3))


def _surface_diff(row, s, d, t):
    """The secant bracket's residual at ray parameter t and its
    intermediates: (p, pd, q, braw, b, f, sd, diff)."""
    n, c = _normal_of(row), row[:, _C]
    p = tuple(s[x] + t * d[x] for x in range(3))
    pd = _dot(p, n) - c
    q = tuple(p[x] - n[x] * pd for x in range(3))
    braw = _apply_mat(row, q)
    b = _clamp_bary(braw)
    f = _interp(row, b)
    sd = _dot(f, n) - c
    return p, pd, q, braw, b, f, sd, pd.abs() - sd.abs()


def _bracket(row, s, d):
    """Everything before the Newton loop (intersect._candidates_core): a dict
    of the ray x plane hit, its validity, the bracket [closer, further], the
    secant estimate and the first middle."""
    n, c = _normal_of(row), row[:, _C]
    h_in, h_out = row[:, _H_IN], row[:, _H_OUT]
    cos_inc = _dot(d, n)
    ds0 = _safe_den(cos_inc)
    dist0r = (c - _dot(n, s)) / ds0
    valid = (cos_inc.abs() >= CFG.ray_plane_intersection_epsilon) & (dist0r > 0.0)
    valid = valid & (dist0r.abs() > -h_in) & (dist0r.abs() > h_out)
    dist0 = torch.where(valid, dist0r, 1.0)
    cosv = torch.where(valid, cos_inc, 1.0)
    dsc = _safe_den(cosv)
    d_in, d_out = h_in / dsc, h_out / dsc
    going = cosv > 0.0
    closer = dist0 + torch.where(going, d_in, d_out)
    further = dist0 + torch.where(going, d_out, d_in)
    dc = _surface_diff(row, s, d, closer)[-1]
    df = _surface_diff(row, s, d, further)[-1]
    denom = dc - df
    dsd = _safe_den(denom)
    secant = (dc * further - df * closer) / dsd
    fallback = denom.abs() < CFG.intersection_estimation_epsilon
    mraw = torch.where(fallback, (closer + further) / 2.0, secant)
    if CFG.clamp_secant_estimate:
        lo, hi = torch.minimum(closer, further), torch.maximum(closer, further)
        middle = torch.minimum(torch.maximum(mraw, lo), hi)
    else:
        middle = mraw.clamp(-_MIDDLE_CLAMP, _MIDDLE_CLAMP)
    return dict(cos_inc=cos_inc, ds0=ds0, dist0r=dist0r, valid=valid, cosv=cosv, dsc=dsc,
                d_in=d_in, d_out=d_out, going=going, closer=closer, further=further,
                dc=dc, df=df, denom=denom, dsd=dsd, secant=secant, fallback=fallback,
                mraw=mraw, middle=middle)


def _newton(row, s, d, m, pd):
    """One Newton iteration from (middle m, projection direction pd): a dict
    of its intermediates, the next middle `m_next` and direction `pd_next`."""
    n, c = _normal_of(row), row[:, _C]
    p = tuple(s[x] + m * d[x] for x in range(3))
    tnum = c - _dot(n, p)
    pdn = _dot(pd, n)
    dst = _safe_den(pdn)
    t = tnum / dst
    pl = tuple(p[x] + t * pd[x] for x in range(3))
    braw = _apply_mat(row, pl)
    b = _clamp_bary(braw)
    nm = _normal_parts(row, b)[-1]
    f = _interp(row, b)
    step = tuple(f[x] - pl[x] for x in range(3))
    st2 = _dot(step, step)
    inv = _inv_norm(st2)
    moved = st2 > 0.0
    pd_next = tuple(torch.where(moved, step[x] * inv, pd[x]) for x in range(3))
    rel = tuple(f[x] - s[x] for x in range(3))
    mnum, mden = _dot(rel, nm), _dot(d, nm)
    dsm = _safe_den(mden)
    q = mnum / dsm
    return dict(p=p, tnum=tnum, pdn=pdn, dst=dst, t=t, pl=pl, braw=braw, b=b, nm=nm, f=f,
                step=step, st2=st2, inv=inv, moved=moved, rel=rel, mnum=mnum, mden=mden,
                dsm=dsm, q=q, m_next=q.clamp(-_MIDDLE_CLAMP, _MIDDLE_CLAMP), pd_next=pd_next)


def _forward_state(row, s, d):
    """(bracket, [(m_k, pd_k)] for each iteration k, the last iteration's
    dict): the forward, keeping what the reverse sweep starts from."""
    br = _bracket(row, s, d)
    m, pd = br["middle"], _normal_of(row)
    inputs, it = [], None
    for _ in range(CFG.root_search_iterations):
        inputs.append((m, pd))
        it = _newton(row, s, d, m, pd)
        m, pd = it["m_next"], it["pd_next"]
    return br, inputs, it


def _div_den_grad(g, quotient, den, ds):
    """The gradient that reaches den of q = num / safe_den(den): none where
    the denominator was clamped."""
    return torch.where(den.abs() < _SAFE_DIV_EPS, 0.0, -g * (quotient / ds))


def _sign_grad(g, x):
    """g * sign(x): abs's backward (0 at 0)."""
    return torch.where(x > 0.0, g, torch.where(x < 0.0, -g, 0.0))


def _in_range_grad(g, x, bound):
    """clamp(x, -bound, bound)'s backward: g on the closed interval."""
    return torch.where((x >= -bound) & (x <= bound), g, 0.0)


def _inv_norm_grad(n2, inv, g_inv):
    """The gradient that reaches n2 of inv = _inv_norm(n2): reciprocal then
    square root, nothing below the epsilon."""
    r = torch.sqrt(n2.clamp_min(_NORMALIZE_EPS))
    g_r = -g_inv * (inv * inv)
    return torch.where(n2 < _NORMALIZE_EPS, 0.0, g_r / (2.0 * r))


def _interp_bwd(row, b, g_f, acc, g_b):
    """Reverse of f = _interp(row, b): adds into the control-net columns of
    acc and into g_b.  The weights' products are taken back one by one, the
    last one first, as autograd takes back `_bernstein` (bezier/patches.py),
    so that both add the same terms in the same order."""
    w = _weights(b)
    for k in range(10):
        for x in range(3):
            acc[3 * k + x] = acc[3 * k + x] + w[k] * g_f[x]
    G = [_rdot(g_f, tuple(_cp(row, k, x) for x in range(3))) for k in range(10)]
    b0, b1, b2 = b
    b0_2, b1_2, b2_2 = b0 * b0, b1 * b1, b2 * b2
    g_b0_2 = G[8] * (3.0 * b2) + G[3] * (3.0 * b1) + G[0] * b0
    g_b1_2 = G[5] * (3.0 * b2) + G[4] * (3.0 * b0) + G[1] * b1
    g_b2_2 = G[7] * (3.0 * b0) + G[6] * (3.0 * b1) + G[2] * b2
    gb0 = (G[9] * b2 * b1 * 6.0 + G[7] * b2_2 * 3.0 + G[4] * b1_2 * 3.0 + G[0] * b0_2
           + g_b0_2 * b0 + g_b0_2 * b0)
    gb1 = (G[9] * b2 * (6.0 * b0) + G[6] * b2_2 * 3.0 + G[3] * b0_2 * 3.0 + G[1] * b1_2
           + g_b1_2 * b1 + g_b1_2 * b1)
    gb2 = (G[9] * (6.0 * b0 * b1) + G[8] * b0_2 * 3.0 + G[5] * b1_2 * 3.0 + G[2] * b2_2
           + g_b2_2 * b2 + g_b2_2 * b2)
    g_b[0], g_b[1], g_b[2] = g_b[0] + gb0, g_b[1] + gb1, g_b[2] + gb2


def _normal_bwd(row, b, g_nm, acc, g_b):
    """Reverse of the unit normal at bary b (_normal_parts): adds into the
    control-net and deriv_b columns of acc and into g_b."""
    comp0, comp1, comp2, A, B, v, n2, inv, _ = _normal_parts(row, b)
    db = (row[:, _DB], row[:, _DB + 1], row[:, _DB + 2])
    g_v = [g_nm[x] * inv for x in range(3)]
    g_n2 = _inv_norm_grad(n2, inv, _rdot(g_nm, v))
    g_v = [g_v[x] + g_n2 * v[x] + g_n2 * v[x] for x in range(3)]
    g_A = (g_v[2] * B[1] - g_v[1] * B[2], g_v[0] * B[2] - g_v[2] * B[0],
           g_v[1] * B[0] - g_v[0] * B[1])
    g_B = (g_v[1] * A[2] - g_v[2] * A[1], g_v[2] * A[0] - g_v[0] * A[2],
           g_v[0] * A[1] - g_v[1] * A[0])
    g_c0 = [g_A[x] + db[0] * g_B[x] for x in range(3)]
    g_c1 = [db[1] * g_B[x] for x in range(3)]
    g_c2 = [db[2] * g_B[x] - g_A[x] for x in range(3)]
    for j, comp in enumerate((comp0, comp1, comp2)):
        acc[_DB + j] = acc[_DB + j] + _rdot(g_B, comp)
    # each control point's terms one by one, the last component's first, as
    # autograd adds each use of a control point into its gradient
    b0_2, b1_2, b2_2, ab, bc, ac = _quadratics(b)
    uses = ((g_c2, ((2, b2_2), (5, b1_2), (6, bc), (7, ac), (8, b0_2), (9, ab))),
            (g_c1, ((1, b1_2), (3, b0_2), (4, ab), (5, bc), (6, b2_2), (9, ac))),
            (g_c0, ((0, b0_2), (3, ab), (4, b1_2), (7, b2_2), (8, ac), (9, bc))))
    for g_c, terms in uses:
        for k, mono in terms:
            for x in range(3):
                acc[3 * k + x] = acc[3 * k + x] + mono * g_c[x]

    def monomial(k0, k1, k2):
        # the cotangent of a quadratic that multiplies control point k0 in
        # comp0, k1 in comp1 and k2 in comp2: each component's sum over the
        # axes, added last component first
        t0, t1, t2 = (_rdot(g_c, tuple(_cp(row, k, x) for x in range(3)))
                      for g_c, k in ((g_c0, k0), (g_c1, k1), (g_c2, k2)))
        return t2 + t1 + t0

    G_b0_2, G_b1_2, G_b2_2 = monomial(0, 3, 8), monomial(4, 1, 5), monomial(7, 6, 2)
    G_ab, G_bc, G_ac = monomial(3, 4, 9), monomial(9, 5, 6), monomial(8, 9, 7)
    # the quadratics taken back the last one first, as autograd takes back
    # `patch_normal`
    b0, b1, b2 = b
    g_b[0] = g_b[0] + (G_ac * b2 * 2.0 + G_ab * b1 * 2.0 + G_b0_2 * b0 + G_b0_2 * b0)
    g_b[1] = g_b[1] + (G_bc * b2 * 2.0 + G_ab * (2.0 * b0) + G_b1_2 * b1 + G_b1_2 * b1)
    g_b[2] = g_b[2] + (G_ac * (2.0 * b0) + G_bc * (2.0 * b1) + G_b2_2 * b2 + G_b2_2 * b2)


def _add_bary_mat_grad(row, g_braw, v, acc, g_v):
    """Reverse of braw = M @ v: adds g_braw_i * v_j into M's columns of acc
    and M^T g_braw into g_v (a list, updated in place; None: it starts at
    the first term), the last row of M first."""
    for i in range(3):
        for j in range(3):
            acc[_M + 3 * i + j] = acc[_M + 3 * i + j] + g_braw[i] * v[j]
    for j in range(3):
        for i in (2, 1, 0):
            term = _mat(row, i, j) * g_braw[i]
            g_v[j] = term if g_v[j] is None else g_v[j] + term


def _surface_diff_bwd(row, s, d, t, g, acc, gs, gd):
    """Reverse of diff = _surface_diff(row, s, d, t) with cotangent g:
    adds into acc, gs and gd; returns the gradient of t."""
    n = _normal_of(row)
    p, pd, q, braw, b, f, sd, _ = _surface_diff(row, s, d, t)
    g_pd = _sign_grad(g, pd)
    g_sd = _sign_grad(-g, sd)
    g_f = [g_sd * n[x] for x in range(3)]
    for x in range(3):
        acc[_N + x] = acc[_N + x] + g_sd * f[x]
    acc[_C] = acc[_C] - g_sd
    g_b = [torch.zeros_like(g) for _ in range(3)]
    _interp_bwd(row, b, g_f, acc, g_b)
    g_braw = [_in_range_grad(g_b[i], braw[i], _BARY_CLAMP) for i in range(3)]
    g_q = [None] * 3
    _add_bary_mat_grad(row, g_braw, q, acc, g_q)
    g_p = list(g_q)
    for x in range(3):
        acc[_N + x] = acc[_N + x] - g_q[x] * pd
    g_pd = g_pd - _rdot(g_q, n)
    for x in range(3):
        g_p[x] = g_p[x] + g_pd * n[x]
        acc[_N + x] = acc[_N + x] + g_pd * p[x]
    acc[_C] = acc[_C] - g_pd
    for x in range(3):
        gs[x] = gs[x] + g_p[x]
        gd[x] = gd[x] + g_p[x] * t
    return _rdot(g_p, d)


def _newton_bwd(row, s, d, m, pd, g_mn, g_pdn, g_f, g_nm, g_b, acc, gs, gd):
    """Reverse of one Newton iteration (`_newton` from m, pd), with the
    cotangents of its next middle g_mn, next direction g_pdn and of its
    surface point g_f, normal g_nm and bary g_b (lists, updated in place):
    adds into acc, gs and gd; returns the gradients of (m, pd)."""
    n = _normal_of(row)
    it = _newton(row, s, d, m, pd)
    nm, rel, step, inv, pl, t = it["nm"], it["rel"], it["step"], it["inv"], it["pl"], it["t"]
    g_q = _in_range_grad(g_mn, it["q"], _MIDDLE_CLAMP)
    g_mnum = g_q / it["dsm"]
    g_mden = _div_den_grad(g_q, it["q"], it["mden"], it["dsm"])
    g_rel = [g_mnum * nm[x] for x in range(3)]
    for x in range(3):
        gd[x] = gd[x] + g_mden * nm[x]
        g_nm[x] = g_nm[x] + g_mden * d[x]
        g_nm[x] = g_nm[x] + g_mnum * rel[x]
    for x in range(3):
        g_f[x] = g_f[x] + g_rel[x]
        gs[x] = gs[x] - g_rel[x]
    moved = it["moved"]
    g_nd = [torch.where(moved, g_pdn[x], 0.0) for x in range(3)]
    g_pd = [torch.where(moved, 0.0, g_pdn[x]) for x in range(3)]
    g_step = [g_nd[x] * inv for x in range(3)]
    g_st2 = _inv_norm_grad(it["st2"], inv, _rdot(g_nd, step))
    g_step = [g_step[x] + g_st2 * step[x] + g_st2 * step[x] for x in range(3)]
    for x in range(3):
        g_f[x] = g_f[x] + g_step[x]
    g_pl = [-g_step[x] for x in range(3)]
    _interp_bwd(row, it["b"], g_f, acc, g_b)
    _normal_bwd(row, it["b"], g_nm, acc, g_b)
    g_braw = [_in_range_grad(g_b[i], it["braw"][i], _BARY_CLAMP) for i in range(3)]
    _add_bary_mat_grad(row, g_braw, pl, acc, g_pl)
    g_p = list(g_pl)
    g_t = _rdot(g_pl, pd)
    for x in range(3):
        g_pd[x] = g_pd[x] + g_pl[x] * t
    g_tnum = g_t / it["dst"]
    g_pdn_dot = _div_den_grad(g_t, t, it["pdn"], it["dst"])
    for x in range(3):
        g_pd[x] = g_pd[x] + g_pdn_dot * n[x]
        acc[_N + x] = acc[_N + x] + g_pdn_dot * pd[x]
    acc[_C] = acc[_C] + g_tnum
    for x in range(3):
        acc[_N + x] = acc[_N + x] - g_tnum * it["p"][x]
        g_p[x] = g_p[x] - g_tnum * n[x]
    for x in range(3):
        gs[x] = gs[x] + g_p[x]
        gd[x] = gd[x] + g_p[x] * m
    return _rdot(g_p, d), g_pd


def _split_grad(g, a, b, lost):
    """torch.minimum / maximum's backward to its operand a against b: half of
    g at a tie, nothing where a lost (lost(a, b): a > b for minimum, a < b
    for maximum), else all of it."""
    return torch.where(lost(a, b), 0.0, torch.where(a == b, g * 0.5, g))


def _bracket_bwd(row, s, d, br, g_m0, g_pd0, acc, gs, gd):
    """Reverse of `_bracket` and of proj_dir's start at the plane normal, with
    the cotangents of the first middle g_m0 and direction g_pd0."""
    n, h_in, h_out = _normal_of(row), row[:, _H_IN], row[:, _H_OUT]
    for x in range(3):
        acc[_N + x] = acc[_N + x] + g_pd0[x]
    closer, further, mraw = br["closer"], br["further"], br["mraw"]
    if CFG.clamp_secant_estimate:
        lo, hi = torch.minimum(closer, further), torch.maximum(closer, further)
        y = torch.maximum(mraw, lo)
        g_y = _split_grad(g_m0, y, hi, torch.gt)
        g_hi = _split_grad(g_m0, hi, y, torch.gt)
        g_mraw = _split_grad(g_y, mraw, lo, torch.lt)
        g_lo = _split_grad(g_y, lo, mraw, torch.lt)
        g_closer = (_split_grad(g_hi, closer, further, torch.lt)
                    + _split_grad(g_lo, closer, further, torch.gt))
        g_further = (_split_grad(g_hi, further, closer, torch.lt)
                     + _split_grad(g_lo, further, closer, torch.gt))
    else:
        g_mraw = _in_range_grad(g_m0, mraw, _MIDDLE_CLAMP)
        g_closer = torch.zeros_like(g_m0)
        g_further = torch.zeros_like(g_m0)
    fallback = br["fallback"]
    g_mid = torch.where(fallback, g_mraw, 0.0)
    g_sec = torch.where(fallback, 0.0, g_mraw)
    g_closer = g_closer + g_mid * 0.5
    g_further = g_further + g_mid * 0.5
    g_secnum = g_sec / br["dsd"]
    g_denom = _div_den_grad(g_sec, br["secant"], br["denom"], br["dsd"])
    g_dc = g_secnum * further
    g_further = g_further + g_secnum * br["dc"]
    g_df = -g_secnum * closer
    g_closer = g_closer - g_secnum * br["df"]
    g_dc = g_dc + g_denom
    g_df = g_df - g_denom
    g_further = g_further + _surface_diff_bwd(row, s, d, further, g_df, acc, gs, gd)
    g_closer = g_closer + _surface_diff_bwd(row, s, d, closer, g_dc, acc, gs, gd)
    going, dsc = br["going"], br["dsc"]
    g_dist0 = g_closer + g_further
    g_din = torch.where(going, g_closer, g_further)
    g_dout = torch.where(going, g_further, g_closer)
    acc[_H_IN] = acc[_H_IN] + g_din / dsc
    acc[_H_OUT] = acc[_H_OUT] + g_dout / dsc
    g_cosv = torch.where(br["cosv"].abs() < _SAFE_DIV_EPS, 0.0,
                         -g_dout * (br["d_out"] / dsc) + -g_din * (br["d_in"] / dsc))
    valid = br["valid"]
    g_dist0r = torch.where(valid, g_dist0, 0.0)
    g_cos = torch.where(valid, g_cosv, 0.0)
    g_num0 = g_dist0r / br["ds0"]
    g_cos = g_cos + _div_den_grad(g_dist0r, br["dist0r"], br["cos_inc"], br["ds0"])
    acc[_C] = acc[_C] + g_num0
    for x in range(3):
        acc[_N + x] = acc[_N + x] - g_num0 * s[x]
        gs[x] = gs[x] - g_num0 * n[x]
    for x in range(3):
        gd[x] = gd[x] + g_cos * n[x]
        acc[_N + x] = acc[_N + x] + g_cos * d[x]


def recompute_adjoint_reference(table, idx, start, direction, any_hit, g_distance,
                                g_point, g_normal, g_bary, g_cos):
    """Plain version of the backward kernel: the reverse sweep of the
    recompute on each ray's row table[idx] (module docstring), from the
    cotangents of the RayHit fields distance [R] (0 where not any_hit: the
    field is the sentinel there), point, normal, bary [R, 3] and
    cos_incidence [R].  Returns (row gradients [R, 60], the dividers' columns
    0; gradient of start [R, 3]; gradient of direction [R, 3])."""
    if CFG.root_search_iterations < 1:
        raise ValueError("the recompute needs at least one Newton iteration")
    with torch.no_grad():
        row = table.detach()[idx]
        s = tuple(start.detach()[:, x] for x in range(3))
        d = tuple(direction.detach()[:, x] for x in range(3))
        br, inputs, last = _forward_state(row, s, d)
        zero = torch.zeros_like(s[0])
        acc = [zero] * N_GRAD
        gs, gd = [zero] * 3, [zero] * 3
        nm = last["nm"]
        g_nm = [g_normal[:, x] + g_cos * d[x] for x in range(3)]
        for x in range(3):
            gd[x] = gd[x] + g_cos * nm[x]
        g_m, g_pd = zero, [zero] * 3
        K = len(inputs)
        for k in range(K - 1, -1, -1):
            m, pd = inputs[k]
            if k == K - 1:
                g_f, g_n, g_b = [g_point[:, x] for x in range(3)], g_nm, \
                    [g_bary[:, x] for x in range(3)]
            else:
                g_f, g_n, g_b = [zero] * 3, [zero] * 3, [zero] * 3
            g_m, g_pd = _newton_bwd(row, s, d, m, pd, g_m, g_pd, g_f, g_n, g_b, acc, gs, gd)
            if k == K - 1:
                g_m = g_m + torch.where(any_hit, g_distance, 0.0)
        _bracket_bwd(row, s, d, br, g_m, g_pd, acc, gs, gd)
        rows = torch.cat([torch.stack(acc, dim=1),
                          torch.zeros((row.shape[0], N_COLS - N_GRAD), dtype=row.dtype,
                                      device=row.device)], dim=1)
        return rows, torch.stack(gs, dim=1), torch.stack(gd, dim=1)


# ---------------------------------------------------------------------------
# the kernels: build, load, launch
# ---------------------------------------------------------------------------

_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# cbtr_recompute's parameters: table, idx, start, direction, any_hit, win, 8
# outputs, P, R, the config (iterations, 4 tolerances, clamp_secant), the
# stream; cbtr_recompute_backward's: table, idx, start, direction, any_hit,
# 5 cotangents, row gradients, start and direction gradients, P, R, the
# config, the stream
_CONFIG_ARGTYPES = [_CI] + [_CF] * 4 + [_CI]
_FORWARD_ARGTYPES = [_VP] * 14 + [_CI] * 2 + _CONFIG_ARGTYPES + [_VP]
_BACKWARD_ARGTYPES = [_VP] * 13 + [_CI] * 2 + _CONFIG_ARGTYPES + [_VP]


def _library():
    """csrc/recompute.cu's library (`cuda_sweep.load_library`) with both
    entry points declared."""
    from . import cuda_sweep as cs

    lib = cs.load_library("recompute", _FORWARD_ARGTYPES)
    if lib.cbtr_recompute_backward.argtypes is None:
        lib.cbtr_recompute_backward.restype = ctypes.c_int
        lib.cbtr_recompute_backward.argtypes = _BACKWARD_ARGTYPES
    return lib


# cbtr_recompute_attributes' out[0..4]
ATTRIBUTE_NAMES = ("registers", "local_bytes", "shared_bytes", "threads", "blocks_per_sm")


def attributes(backward: bool) -> dict:
    """The forward or the backward kernel's build and occupancy
    (ATTRIBUTE_NAMES): the device's answer for its registers, local memory
    (stack frame and spills) and static shared memory, and the blocks of
    its launch one SM holds."""
    lib = _library()
    entry = lib.cbtr_recompute_attributes
    entry.restype = ctypes.c_int
    entry.argtypes = [_CI, _VP]
    out = (ctypes.c_int * len(ATTRIBUTE_NAMES))()
    rc = entry(int(backward), ctypes.cast(out, _VP))
    if rc != 0:
        raise RuntimeError(f"cbtr_recompute_attributes failed: "
                           f"{lib.cbtr_cuda_error_string(rc).decode()} ({rc})")
    return dict(zip(ATTRIBUTE_NAMES, out))


def ptxas_summary(log: str) -> dict:
    """{"recompute_forward_kernel" | "recompute_backward_kernel": {stack,
    spill_stores, spill_loads, registers, shared_bytes}} from nvcc's
    -Xptxas -v output (`cuda_sweep.build_library`'s log)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*?(recompute_(?:forward|backward)_kernel)", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out[name].update(registers=int(m.group(1)),
                             shared_bytes=int(smem.group(1)) if smem else 0)
            name = None
    return out


@contextlib.contextmanager
def newton_iterations(n: int):
    """The recompute at n Newton iterations, the kernels (`_config`) and
    their plain versions (which read `intersect`'s config) alike."""
    from . import intersect as ix

    global CFG
    saved = CFG, ix.CFG
    CFG = ix.CFG = dataclasses.replace(CFG, root_search_iterations=n)
    try:
        yield
    finally:
        CFG, ix.CFG = saved


def _config():
    iters = int(CFG.root_search_iterations)
    if not 1 <= iters <= _MAX_ITERS:
        raise ValueError(f"the recompute kernels take 1 to {_MAX_ITERS} Newton iterations, "
                         f"got {iters}")
    return (iters, CFG.ray_plane_intersection_epsilon, CFG.intersection_estimation_epsilon,
            CFG.max_intersection_distance_from_ray, CFG.minimal_ray_distance,
            int(CFG.clamp_secant_estimate))


def _check(table, idx, start, direction, any_hit, win=None, cotangents=()):
    """The kernels' inputs: a contiguous f32 [P, 60] CUDA table, int64 ids
    [R], contiguous f32 [R, 3] rays, bool any_hit [R], int32 win [R], f32
    cotangents of the fields' shapes, all on the table's device."""
    device = table.device
    if device.type != "cuda":
        raise ValueError(f"the recompute kernels run on CUDA tensors, got {device}; on the "
                         "CPU their plain versions compute the same function")
    R = idx.shape[0] if idx.dim() == 1 else -1
    want = [(table, "table", torch.float32, (table.shape[0], N_COLS)),
            (idx, "idx", torch.int64, (R,)),
            (start, "start", torch.float32, (R, 3)),
            (direction, "direction", torch.float32, (R, 3)),
            (any_hit, "any_hit", torch.bool, (R,))]
    if win is not None:
        want.append((win, "win", torch.int32, (R,)))
    for name, t in cotangents:
        want.append((t, name, torch.float32, (R, 3) if t.dim() == 2 else (R,)))
    for t, name, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() \
                or t.device != device:
            raise ValueError(f"{name}: the recompute kernels take a contiguous {dtype} "
                             f"{shape} tensor on {device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device} (contiguous={t.is_contiguous()})")
    if R < 0 or table.shape[0] < 1 or table.shape[0] >= 2**31 or R >= 2**31:
        raise ValueError(f"unsupported shape: table {tuple(table.shape)}, idx "
                         f"{tuple(idx.shape)}")
    return device, R


def launch_forward(table, idx, start, direction, any_hit, win):
    """One launch of the forward kernel on the current stream: (what,
    distance, point, normal, bary, cos_incidence, patch, gate-OFF what),
    the fields of `recompute_forward_reference`.  A ray whose id lies
    outside [0, P) reads no row: its float fields are NaN (its gradients
    too, in `launch_backward`); nothing is read back to check the ids."""
    device, R = _check(table, idx, start, direction, any_hit, win)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    out = (torch.empty(R, **i32), torch.empty(R, **f32), torch.empty((R, 3), **f32),
           torch.empty((R, 3), **f32), torch.empty((R, 3), **f32), torch.empty(R, **f32),
           torch.empty(R, **i32), torch.empty(R, **i32))
    lib = _library()
    with torch.cuda.device(device), span("cbtr.launch.recompute_forward"):
        rc = lib.cbtr_recompute(
            table.data_ptr(), idx.data_ptr(), start.data_ptr(), direction.data_ptr(),
            any_hit.data_ptr(), win.data_ptr(), *(t.data_ptr() for t in out),
            table.shape[0], R, *_config(), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"recompute forward kernel launch failed: "
                           f"{lib.cbtr_cuda_error_string(rc).decode()} ({rc})")
    COUNTED["recompute_forward"].launches += 1
    return out


def launch_backward(table, idx, start, direction, any_hit, g_distance, g_point, g_normal,
                    g_bary, g_cos):
    """One launch of the backward kernel on the current stream: (row
    gradients [R, 60], start gradient [R, 3], direction gradient [R, 3]),
    those of `recompute_adjoint_reference`."""
    cot = (("g_distance", g_distance), ("g_point", g_point), ("g_normal", g_normal),
           ("g_bary", g_bary), ("g_cos", g_cos))
    device, R = _check(table, idx, start, direction, any_hit, cotangents=cot)
    rows = torch.empty((R, N_COLS), dtype=torch.float32, device=device)
    g_start = torch.empty((R, 3), dtype=torch.float32, device=device)
    g_dir = torch.empty((R, 3), dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device), span("cbtr.launch.recompute_backward"):
        rc = lib.cbtr_recompute_backward(
            table.data_ptr(), idx.data_ptr(), start.data_ptr(), direction.data_ptr(),
            any_hit.data_ptr(), *(t.data_ptr() for _, t in cot), rows.data_ptr(),
            g_start.data_ptr(), g_dir.data_ptr(), table.shape[0], R, *_config(),
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"recompute backward kernel launch failed: "
                           f"{lib.cbtr_cuda_error_string(rc).decode()} ({rc})")
    COUNTED["recompute_backward"].launches += 1
    return rows, g_start, g_dir


def winner_ids(win):
    """The rows the recompute reads: win clamped to >= 0, as int64 (a miss's
    -1 reads row 0; its fields are masked by any_hit)."""
    return win.clamp_min(0).to(torch.int64)


class _Recompute(torch.autograd.Function):
    """The recompute on the kernels: forward `launch_forward`, backward
    `launch_backward` and the segment sum of the row gradients into the
    table.  Both take the rows `winner_ids(win)`.  It saves only its inputs,
    the int32 `win` among them (its backward re-runs the forward in
    registers and takes the ids again), so `intersect_rays` calls it without
    a checkpoint.  `values` holds the table's numbers, which the kernels
    read and the backward keeps in the table's place: a caller that packs
    the table for each chunk passes the numbers of one packing, so that
    every chunk holds that one and its own packing is freed.  The launchers
    are looked up at each call."""

    @staticmethod
    def forward(ctx, table, start, direction, any_hit, win, values):
        out = launch_forward(values, winner_ids(win), start, direction, any_hit, win)
        ctx.save_for_backward(values, start, direction, any_hit, win)
        ctx.mark_non_differentiable(out[0], out[6], out[7])
        return out

    @staticmethod
    @once_differentiable
    @span("cbtr.backward.recompute")
    def backward(ctx, _what, g_dist, g_point, g_normal, g_bary, g_cos, _patch, _what_w):
        table, start, direction, any_hit, win = ctx.saved_tensors
        idx = winner_ids(win)
        rows, g_start, g_dir = launch_backward(
            table, idx, start, direction, any_hit, g_dist.contiguous(), g_point.contiguous(),
            g_normal.contiguous(), g_bary.contiguous(), g_cos.contiguous())
        g_table = (cuda_segment._sum(idx, rows, table.shape[0])
                   if ctx.needs_input_grad[0] else None)
        return (g_table, g_start if ctx.needs_input_grad[1] else None,
                g_dir if ctx.needs_input_grad[2] else None, None, None, None)


def on_kernels(table, backend: str = "auto") -> bool:
    """Whether `recompute` runs on the kernel pair (`_Recompute`): a CUDA
    table on backend "auto" (`intersect.BACKENDS`).  The pair keeps no
    residuals, only its inputs, so a checkpoint around it would save nothing
    and launch its forward again in the backward; the plain version keeps
    every Newton residual."""
    return backend == "auto" and table.is_cuda


def recompute(table, start, direction, any_hit, win, backend: str = "auto", values=None):
    """Recompute wrapper: (RayHit, gate-OFF what) of each ray on its
    winner's row `winner_ids(win)`, as `recompute_reference`.

    Where `on_kernels` (CUDA tensors, backend "auto") it runs `_Recompute`
    on the kernels (f32 table and rays, int32 win: anything else raises),
    and a build or launch failure raises; otherwise `recompute_reference`.
    There is no fallback between the two.  values: the table's numbers
    from a packing the caller keeps for several calls (`_Recompute`; None:
    the table's own)."""
    if not on_kernels(table, backend):
        return recompute_reference(table, winner_ids(win), start, direction, any_hit, win)
    return recompute_kernels(table, start, direction, any_hit, win, values=values)


def recompute_kernels(table, start, direction, any_hit, win, values=None):
    """`_Recompute` on the launchers: (RayHit, gate-OFF what)."""
    from . import intersect as ix

    table = table.contiguous()
    values = table.detach() if values is None else values.detach().contiguous()
    if values.shape != table.shape:
        raise ValueError(f"values {tuple(values.shape)} are not the table's numbers "
                         f"{tuple(table.shape)}")
    out = _Recompute.apply(table, start.contiguous(), direction.contiguous(),
                           any_hit.contiguous(), win.contiguous(), values)
    return ix.RayHit(*out[:7]), out[7]


launch_forward.launches = 0
launch_backward.launches = 0
# the launchers whose `launches` count each kernel's launches (held here, so
# that a stage profiler which wraps the module's functions counts on them)
COUNTED = {"recompute_forward": launch_forward, "recompute_backward": launch_backward}

"""Ray x Bezier-patch intersection.

Counterpart of cbtr_tpu/ops/intersect.py: a branch-free, batched re-design
of BezierTriangle::intersect + BezierMesh::intersect
(reference/bezierTriangle.cpp:123-195, reference/bezierMesh.cpp:206-227).

The op runs in three stages:

1. **sweep** (gradient-free): for every (ray, patch) pair evaluate the
   candidate with the barycentric domain gate OFF and keep
   ``code = what | (in_domain << 3)`` plus the along-ray distance.  The
   gate-ON result follows from the gate-OFF one because the gate only ANDs
   one more condition into validity.
2. **select** (integer ops): reconstruct the reference's two-pass semantics
   (gate-ON candidate; a cFollowSide result retries the indicated
   neighbour with the gate OFF) and pick the min-distance cIntersect, lowest
   patch id on ties.
3. **recompute** (differentiable): re-evaluate the single winning patch per
   ray for point/normal/bary/cos.  Gradients flow only through this O(rays)
   stage.  On the GPU its forward and backward are the two kernels of
   csrc/recompute.cu (`cuda_recompute`); `_candidates_core` below is their
   plain version.

Stages 1+2 are `cuda_sweep.sweep_select` (K1, P <= 1024) or
`cuda_winner.sweep_winner` (K2, P > 1024): a CUDA kernel for tensors on the
GPU, its plain PyTorch twin for tensors on the CPU.  `sweep_codes` and
`select_candidates` are the staged plain form the twin is built from.
`candidates_with_retry` + `select_best` are the dense debug formulation of
the same semantics (every pair's candidate, the retry re-evaluated per
pair); `intersect_rays` never calls them.

Every division and normalization is epsilon-guarded, and lanes already known
dead carry tame values, so no NaN reaches a gradient (the JAX package's
gradient hygiene, kept bit for bit).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import geom
from ..config import DEFAULT as CFG
from ..bezier.patches import BezierPatches, interpolate, patch_normal
from . import cuda_recompute

# BezierIntersection::What (reference/bezierTriangle.h:8-14)
WHAT_FOLLOW_SIDE0 = 0
WHAT_FOLLOW_SIDE1 = 1
WHAT_FOLLOW_SIDE2 = 2
WHAT_NONE = 3
WHAT_INTERSECT = 4

# sentinel distance for missed rays
_BIG = 3.4e38

BACKENDS = ("auto", "plain")


class RayHit(NamedTuple):
    """Per-ray intersection record (reference BezierIntersection + patch id)."""

    what: torch.Tensor           # [...] i32
    distance: torch.Tensor       # [...] f32 (along-ray)
    point: torch.Tensor          # [..., 3]
    normal: torch.Tensor         # [..., 3] unit surface normal
    bary: torch.Tensor           # [..., 3]
    cos_incidence: torch.Tensor  # [...] dot(ray dir, normal)
    patch: torch.Tensor          # [...] i32 winning patch (or -1)


def _clip(x, lo, hi):
    """jnp.clip with tensor bounds: maximum, then minimum (the same values
    and the same gradient split at ties as the JAX package)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _candidates_core(patches: BezierPatches, start, direction):
    """Gate-OFF candidate evaluation of every ray against every patch row.

    patches leaves have leading shape [...]; start/direction broadcast with
    it.  Returns (what, distance, point, normal, bary, cos_out, in_dom) where
    in_dom is the barycentric in-[0,1] gate of LimitPlaneIntersection::cThis
    (reference/bezierTriangle.cpp:127-131); the gate-ON result is the same
    candidate with ``valid &= in_dom``.

    csrc/candidate.cuh::candidate_code evaluates the same expressions in
    the same order; keep the two in step.
    """
    cp = patches.control_points
    n = geom.plane_normal(patches.underlying)
    c = geom.plane_constant(patches.underlying)
    h_in = patches.heights[..., 0]
    h_out = patches.heights[..., 1]

    # ray x underlying plane (reference/bezierTriangle.cpp:124-126)
    cos_inc = geom.dot(direction, n)
    dist0 = geom.safe_div(c - geom.dot(n, start), cos_inc)
    valid = (cos_inc.abs() >= CFG.ray_plane_intersection_epsilon) & (dist0 > 0.0)
    # self-reintersection slab gate
    valid = valid & (dist0.abs() > -h_in) & (dist0.abs() > h_out)

    point0 = start + dist0[..., None] * direction
    bary0 = geom.apply_mat3(patches.bary_inverse, point0)
    in_dom = ((bary0 >= 0.0) & (bary0 <= 1.0)).all(dim=-1)

    # Gradient hygiene: dead lanes still run the arithmetic below; tame
    # values keep inf out of the forward pass, where a masked 0 cotangent
    # times inf would sum NaN into real control-point gradients.
    dist0 = torch.where(valid, dist0, 1.0)
    cos_inc = torch.where(valid, cos_inc, 1.0)

    # bracket along the ray (reference/bezierTriangle.cpp:132-135)
    d_in = geom.safe_div(h_in, cos_inc)
    d_out = geom.safe_div(h_out, cos_inc)
    going = cos_inc > 0.0
    closer = dist0 + torch.where(going, d_in, d_out)
    further = dist0 + torch.where(going, d_out, d_in)

    def surface_diff(t):
        p = start + t[..., None] * direction
        pd = geom.dot(p, n) - c
        q = p - n * pd[..., None]
        b = geom.apply_mat3(patches.bary_inverse, q).clamp(-16.0, 16.0)
        surf = interpolate(cp, b)
        return pd.abs() - (geom.dot(surf, n) - c).abs()

    # secant-style estimate with midpoint fallback (cpp:137-152)
    diff_closer = surface_diff(closer)
    diff_further = surface_diff(further)
    denom = diff_closer - diff_further
    secant = geom.safe_div(diff_closer * further - diff_further * closer, denom)
    middle = torch.where(
        denom.abs() < CFG.intersection_estimation_epsilon,
        (closer + further) / 2.0,
        secant,
    )
    if CFG.clamp_secant_estimate:
        # keep the first estimate inside the bracket (see config.py)
        middle = _clip(middle, torch.minimum(closer, further),
                       torch.maximum(closer, further))
    else:
        middle = middle.clamp(-1e7, 1e7)

    # fixed-iteration Newton-like refinement (cpp:155-164)
    proj_dir = n.expand(middle.shape + (3,))
    distance = middle
    for _ in range(CFG.root_search_iterations):
        distance = middle
        p = start + middle[..., None] * direction
        t = geom.safe_div(c - geom.dot(n, p), geom.dot(proj_dir, n))
        plane_pt = p + t[..., None] * proj_dir
        bary = geom.apply_mat3(patches.bary_inverse, plane_pt).clamp(-16.0, 16.0)
        normal = patch_normal(cp, patches.deriv_b, bary)
        surf_pt = interpolate(cp, bary)
        step = surf_pt - plane_pt
        new_dir = geom.safe_normalize(step)
        # keep the previous direction when the step vanished (converged lane)
        proj_dir = torch.where(
            (geom.dot(step, step) > 0.0)[..., None], new_dir, proj_dir
        )
        middle = geom.safe_div(
            geom.dot(surf_pt - start, normal), geom.dot(direction, normal)
        ).clamp(-1e7, 1e7)

    # acceptance (cpp:165-167): point close to the ray line AND beyond the slab
    rel = surf_pt - start
    perp = rel - geom.dot(rel, direction)[..., None] * direction
    accept = (geom.norm(perp) <= CFG.max_intersection_distance_from_ray) & (
        distance >= (further - closer) * CFG.minimal_ray_distance
    )
    valid = valid & accept

    # domain classification against divider planes (cpp:169-184)
    d_div = geom.plane_distance(patches.dividers, surf_pt[..., None, :])  # [...,3]
    outside = (
        (d_div[..., 0] < 0.0).to(torch.int32)
        + (d_div[..., 1] < 0.0).to(torch.int32) * 2
        + (d_div[..., 2] < 0.0).to(torch.int32) * 4
    )
    what = torch.full_like(outside, WHAT_INTERSECT)
    what = torch.where(outside == 1, WHAT_FOLLOW_SIDE0, what)
    what = torch.where(outside == 2, WHAT_FOLLOW_SIDE1, what)
    what = torch.where(outside == 4, WHAT_FOLLOW_SIDE2, what)
    what = torch.where(valid, what, WHAT_NONE).to(torch.int32)
    cos_out = geom.dot(direction, normal)
    return what, distance, surf_pt, normal, bary, cos_out, in_dom


def patch_candidates(patches: BezierPatches, start, direction, limit_domain):
    """Candidate intersection of every ray against every given patch row.

    limit_domain=True applies the barycentric in-[0,1] gate.
    Returns (what, distance, point, normal, bary, cos_out).
    """
    what, dist, pt, n, b, cos_out, in_dom = _candidates_core(
        patches, start, direction
    )
    if limit_domain:
        what = torch.where(in_dom, what, WHAT_NONE).to(torch.int32)
    return what, dist, pt, n, b, cos_out


def sweep_codes(patches: BezierPatches, start, direction):
    """Plain sweep: per-(ray, patch) gate-OFF code and distance
    (counterpart of sweep_codes_xla).

    start/direction [R,3]; returns (code [R,P] i32, dist [R,P] f32) with
    ``code = what | (in_dom << 3)``.
    """
    what, dist, _, _, _, _, in_dom = _candidates_core(
        patches, start[:, None, :], direction[:, None, :]
    )
    return what | (in_dom.to(torch.int32) << 3), dist


# above this patch count the [P,P] one-hot vote matmul (memory O(P^2),
# flops O(R*P^2)) loses to the O(R*P) gather formulation
_SELECT_MATMUL_MAX_P = 2048


def select_candidates(code, dist, neighbours):
    """Reconstruct the reference two-pass semantics from sweep codes and pick
    the min-distance winner, lowest patch id on ties
    (reference/bezierMesh.cpp:211-225).

    code/dist [R,P]; neighbours [P,3] i32 (global ids).  Returns
    (any_hit [R] bool, win_patch [R] i32, win_dist [R] f32).

    Two formulations with identical winners:

    * P <= 2048 -- votes: patch q receives "follow votes" from its
      neighbours through three one-hot [R,P] @ [P,P] products (exact in
      f32: 0/1 values, sums <= 3).  A pair (r, q) is a retry candidate iff
      voted and its own gate-OFF result is cIntersect; its distance is read
      in place at slot q.
    * P > 2048 -- column gathers: for side s the index vector
      ``q_s = neighbours[:, s]`` fetches the neighbour's code/dist columns;
      O(R*P) memory, no [P,P] matrix.
    """
    P = code.shape[-1]
    what_off = code & 7
    in_dom = (code >> 3) > 0
    what_on = torch.where(in_dom, what_off, WHAT_NONE)
    hit_off = what_off == WHAT_INTERSECT
    nb = neighbours.to(device=code.device, dtype=torch.int64)

    if P <= _SELECT_MATMUL_MAX_P:
        ids = torch.arange(P, device=code.device)
        votes = torch.zeros(code.shape, dtype=torch.float32, device=code.device)
        for s in range(3):
            a_s = (nb[:, s, None] == ids).to(torch.float32)      # [P, P]
            f_s = (what_on == s).to(torch.float32)               # [R, P]
            votes = votes + f_s @ a_s
        considered = (what_on == WHAT_INTERSECT) | ((votes > 0.0) & hit_off)
        key = torch.where(considered, dist, _BIG)
        best = key.argmin(dim=-1)  # first minimal index: lowest id on ties
        best_key = key.gather(-1, best[:, None])[:, 0]
        return best_key < _BIG, best.to(torch.int32), best_key

    ids = torch.arange(P, dtype=torch.int64, device=code.device)
    # pass 1 (gate ON) direct hits, keyed at their own slot
    key = torch.where(what_on == WHAT_INTERSECT, dist, _BIG)
    win_ids = ids.expand(key.shape)
    for s in range(3):
        q_s = nb[:, s]
        key_s = torch.where(
            (what_on == s) & hit_off[:, q_s], dist[:, q_s], _BIG
        )
        better = key_s < key
        win_ids = torch.where(better, q_s, win_ids)
        key = torch.minimum(key, key_s)
    best = key.argmin(dim=-1)
    best_key = key.gather(-1, best[:, None])[:, 0]
    win = win_ids.gather(-1, best[:, None])[:, 0]
    return best_key < _BIG, win.to(torch.int32), best_key


def recompute_winner(patches: BezierPatches, start, direction, any_hit, win,
                     with_check: bool = False, backend: str = "auto", values=None):
    """Differentiable re-evaluation of each ray's winning patch.

    start, direction [R, 3]; any_hit [R] bool, win [R] i32 from the winner
    search.  backend "auto": CUDA tensors run the recompute kernels
    (`cuda_recompute.recompute`: one forward launch, one backward launch and
    the segment sum of the row gradients into the table; a failed build or
    launch raises), CPU tensors their plain version; "plain": the plain
    version (`cuda_recompute.recompute_reference`: one [R, 60] row gather
    from the packed table, then `patch_candidates`) on any device.
    values: the packed table's numbers, packed once by a caller with many
    chunks; the kernels read and keep those in place of this call's
    packing (`cuda_recompute.recompute`).

    with_check=True additionally returns the number of rays whose winner the
    sweep accepted but the recompute rejects (``what != cIntersect``); a
    nonzero count means the sweep and the recompute disagree on arithmetic.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    hit, what_w = cuda_recompute.recompute(patches.packed_f32(), start, direction, any_hit, win,
                                           backend=backend, values=values)
    if with_check:
        return hit, int((any_hit & (what_w != WHAT_INTERSECT)).sum())
    return hit


def candidates_with_retry(local_patches: BezierPatches,
                          full_patches: BezierPatches, local_base, start,
                          direction):
    """Per-(ray, local patch) candidates after the follow-side retry.

    The dense/debug path; the production path is sweep -> select ->
    recompute.  local_patches: the patch rows this caller scans (a shard or
    the whole table); full_patches: the complete table the retry gathers
    neighbour rows from (neighbour ids are global); local_base: global id
    of local_patches row 0.  start/direction [R,3].

    Returns (what, distance, point, normal, bary, cos, global_patch_id), each
    [R, P_local(, 3)].
    """
    P = local_patches.num_patches
    s = start[:, None, :]  # [R,1,3] broadcast over patches
    d = direction[:, None, :]

    # pass 1: local patches, domain gate ON
    what1, dist1, pt1, n1, b1, cos1 = patch_candidates(local_patches, s, d, True)

    # follow-side retry: evaluate the indicated neighbour, gate OFF
    # (reference/bezierMesh.cpp:213-217)
    follow = what1 < WHAT_NONE
    side = what1.clamp(0, 2).to(torch.int64)
    local_ids = torch.arange(P, device=what1.device)
    nb = local_patches.neighbours.to(torch.int64)[local_ids, side]    # [R,P]
    nb = torch.where(follow, nb, 0)
    rows = full_patches.row(nb)  # [R,P] gathered patch rows
    what2, dist2, pt2, n2, b2, cos2 = patch_candidates(rows, s, d, False)

    def merge(a2, a1):
        return torch.where(follow[..., None] if a1.ndim == 3 else follow, a2, a1)

    hit_patch = torch.where(follow, nb, local_base + local_ids)
    return (
        merge(what2, what1),
        merge(dist2, dist1),
        merge(pt2, pt1),
        merge(n2, n1),
        merge(b2, b1),
        merge(cos2, cos1),
        hit_patch.to(torch.int32),
    )


def select_best(what, dist, pt, n, b, cos, hit_patch) -> RayHit:
    """Min-distance cIntersect wins (reference/bezierMesh.cpp:220-222), the
    lowest patch slot on ties; reduces the trailing patch axis."""
    considered = what == WHAT_INTERSECT
    key = torch.where(considered, dist, _BIG)
    best = key.argmin(dim=-1)  # [R]: the first minimal index

    def pick(m):
        idx = best[:, None, None].expand(-1, 1, 3) if m.ndim == 3 else best[:, None]
        return m.gather(1, idx).squeeze(1)

    any_hit = considered.any(dim=-1)
    return RayHit(
        what=torch.where(any_hit, WHAT_INTERSECT, WHAT_NONE).to(torch.int32),
        distance=torch.where(any_hit, pick(dist), _BIG),
        point=pick(pt),
        normal=pick(n),
        bary=pick(b),
        cos_incidence=pick(cos),
        patch=torch.where(any_hit, pick(hit_patch), -1).to(torch.int32),
    )


def _winner_route(num_patches: int):
    """(wrapper, twin, clamped) of the winner search at num_patches: K1
    (cuda_sweep) up to _FUSED_MAX_P = 1024 patches, K2 (cuda_winner) above,
    as in the JAX package; clamped: whether the kernel reads its neighbour
    ids clamped to [0, P) (K2)."""
    from . import cuda_sweep, cuda_winner

    if num_patches <= cuda_sweep._FUSED_MAX_P:
        return cuda_sweep.sweep_select, cuda_sweep.sweep_select_reference, False
    return cuda_winner.sweep_winner, cuda_winner.sweep_winner_reference, True


def winner_tables(patches: BezierPatches, backend: str = "auto"):
    """The winner kernel's tables for these patches (`cuda_tables.PatchTables`
    at cuda_sweep.BLOCK_P, the neighbours clamped for K2, `_winner_route`):
    one build (`cuda_tables.build_tables`: the table kernel on the card, its
    plain version on the CPU) that every chunk and both refractions of a
    trace share; they are a function of the detached patches alone.  None
    for backend "plain", whose twins build their own."""
    from . import cuda_sweep, cuda_tables

    if backend == "plain":
        return None
    with torch.no_grad():
        return cuda_tables.build_tables(patches.detach(), cuda_sweep.BLOCK_P,
                                        clamp=_winner_route(patches.num_patches)[2])


def _winner_chunk(patches: BezierPatches, start, direction, backend: str, tables=None):
    """Stages 1+2 (sweep + select) for a chunk of rays: the gradient-free
    winner search.  Returns (any_hit [R] bool, win [R] i32).

    P <= 1024 goes to K1 (cuda_sweep), P > 1024 to K2 (cuda_winner), as in
    the JAX package (`_winner_route`).  backend "auto" goes through that
    kernel's wrapper (the kernel on the GPU, its plain twin on the CPU);
    "plain" forces the twin on any device, on tables of its own.  tables:
    `winner_tables(patches)` for backend "auto", built once by the caller
    for all its chunks (None: the kernel's `prepare_inputs` builds them for
    this chunk)."""
    wrapper, twin, _ = _winner_route(patches.num_patches)
    with torch.no_grad():
        p, s, d = patches.detach(), start.detach(), direction.detach()
        if backend == "plain":
            any_hit, win, _ = twin(p, s, d)
        else:
            any_hit, win, _ = wrapper(p, s, d, tables=tables)
    return any_hit, win


def _intersect_chunk(patches: BezierPatches, start, direction, backend: str, tables=None):
    any_hit, win = _winner_chunk(patches, start, direction, backend, tables=tables)
    return recompute_winner(patches, start, direction, any_hit, win, backend=backend)


def intersect_rays(patches: BezierPatches, start, direction,
                   chunk_size: int = 0, backend: str = "auto", tables=None) -> RayHit:
    """Intersect a batch of rays with the whole Bezier surface.

    start/direction: [..., 3].  chunk_size > 0 scans the ray axis in chunks
    of that size.  On the recompute kernels (`cuda_recompute.on_kernels`:
    CUDA patches, backend "auto") a chunk's recompute is called directly: the
    kernel pair keeps no residuals, only its inputs (the packed table's
    numbers, packed once here for every chunk), and its backward re-runs
    the forward in registers.  On the plain version (CPU tensors, backend
    "plain") each chunk's recompute is checkpointed, so backward keeps only
    the 5 B/ray winner and re-runs the O(rays) recompute instead of holding
    every chunk's Newton residuals.
    backend: "auto" (CUDA kernel for GPU tensors, plain twin for CPU
    tensors) or "plain" (the twin on any device; for comparisons).
    tables: `winner_tables(patches, backend)` where the caller has them (a
    trace's two refractions share one build); otherwise they are built here
    once, before the chunk loop.
    Returns a RayHit with leading shape [...].
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    batch_shape = start.shape[:-1]
    s = start.reshape(-1, 3).to(torch.float32)
    d = direction.reshape(-1, 3).to(torch.float32)
    R = s.shape[0]
    if tables is None:
        tables = winner_tables(patches, backend)

    if chunk_size and R > chunk_size:
        values = (patches.detach().packed_f32()
                  if cuda_recompute.on_kernels(patches.control_points, backend) else None)
        chunks = []
        for r0 in range(0, R, chunk_size):
            sc, dc = s[r0:r0 + chunk_size], d[r0:r0 + chunk_size]
            ah, w = _winner_chunk(patches, sc, dc, backend, tables=tables)
            if values is not None:
                chunks.append(recompute_winner(patches, sc, dc, ah, w, backend=backend,
                                               values=values))
            else:
                chunks.append(checkpoint(recompute_winner, patches, sc, dc, ah, w, False,
                                         backend, use_reentrant=False))
        hit = RayHit(*(torch.cat(fields, dim=0) for fields in zip(*chunks)))
    else:
        hit = _intersect_chunk(patches, s, d, backend, tables=tables)
    return RayHit(*(x.reshape(batch_shape + x.shape[1:]) for x in hit))

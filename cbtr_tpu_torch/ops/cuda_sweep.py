"""Fused sweep + select on the GPU: the CUDA kernel K1, its wrapper and its
plain PyTorch twin.

Counterpart of the fused path of cbtr_tpu/ops/pallas_sweep.py
(`_sweep_select_kernel` / `sweep_select_pallas`).  For every ray it returns
the winner of reference/bezierMesh.cpp:206-227's scan with one forward
retry: (any_hit [R] bool, win [R] i32, win_dist [R] f32), min distance,
lowest patch id on ties, without materialising per-pair state.

The candidate set is defined at (128-ray tile x 16-patch block)
granularity, as on the TPU:

* a block is listed for a tile when some ray of the tile hits its merged
  bounding sphere AND its union AABB (`block_bounds`); the kernels cull for
  their own tile (csrc/block_walk.cuh), the plain twins read the same test
  from `tile_block_lists`, and `tile_bitmap_reference` is the kernels' cull
  in plain torch;
* inside a listed block, the block is gated open for all 128 rays when ANY
  (patch, ray) pair of block x tile passes the per-patch sphere test
  (`gated_pairs`);
* pairs of unlisted or ungated blocks produce no candidate (code
  WHAT_NONE), which is part of the semantics.  Where the gate acts it stays
  per block, never per pair, because it defines the retries: a voted
  neighbour is retried where its block was gated open, and a retry is a
  gate-OFF candidate that can converge up to 66x the hull radius out, so a
  per-pair test would drop retries the reference computes.  In the first
  pass per-pair gating is sound: a pair contributes there (a direct hit or
  a vote) only where its gate-ON code holds, i.e. its ray crosses the flat
  triangle of the patch's corners, which are control points, so the ray
  meets the patch's inflated sphere and slack-widened box
  (`patch_box_table`).  K1 evaluates in its first pass only the pairs of
  the gated blocks that pass both (`evaluated_pairs`: about a sixth of the
  gated pairs on a beam through the robot lens), with the survivors dealt
  evenly over the CTA's threads so that no warp waits on another's share
  (csrc/sweep_select.cu); its winners are those of the unit-gated set.

Two options of the JAX package's kernel, off by default: the sweep's
arithmetic (`intersect.sweep_mode()`: config.fast_newton and
config.bf16_sweep, read at every call by the kernel and the twin alike),
and `half_gate` (each half of a listed block behind its own sphere gate,
`gated_pairs`; block_p >= 16, as the JAX package takes it).

A second search over rays that a first one left mostly as they were (the
second refraction of `optics.lens.trace_through_lens`) may take a prior
(`intersect.WinnerPrior`: which rays are alive, the first search's answers):
a 128-ray tile with no live ray returns the prior's answer, which is the
one it would compute, since its rays are the first search's and the answer
is a function of the tile's rays and the tables alone; every other tile is
searched in full (`sweep_select`, `launch`, `sweep_select_reference` alike;
`reuse_counts` counts the tiles).

`sweep_select` launches csrc/sweep_select.cu for CUDA tensors and calls
`sweep_select_reference` for CPU tensors; it never falls back from one to
the other.  The kernels are built with nvcc at first use and launched
through `cuda_lib.call`, as every kernel of the port is.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..bezier.patches import BezierPatches
from ..config import DEFAULT as CFG
from ..utils import profiling
from . import cuda_lib
from . import intersect as ix

# feature-column layout of the row-major [P, 64] patch table
_ROW_CP = 0        # 30 cols: control point k at cols (3k, 3k+1, 3k+2)
_ROW_PLANE = 30    # 4 cols: underlying plane nx, ny, nz, c
_ROW_BINV = 34     # 9 cols: barycentric inverse, row-major
_ROW_H = 43        # 2 cols: heights (inside, outside)
_ROW_DB = 45       # 3 cols: second derivative direction
_ROW_DIV = 48      # 12 cols: 3 divider planes x (nx, ny, nz, c)
_ROW_BSPHERE = 60  # 4 cols: bounding sphere cx, cy, cz, radius (inflated)
_N_ROWS = 64
_N_BOX = 8         # per-patch box table (`patch_box_table`): lo xyz, hi xyz, 0, 0

TILE_R = 128       # rays per tile (one CUDA block, one thread per ray)
BLOCK_P = 16       # patches per candidate block (FUSED_BLOCK_P)
_PATCH_PAD = 128   # patch-table padding (every block size divides it)

# largest patch count of the fused path, as in the JAX package; above it
# intersect_rays runs the winner kernel K2 (cuda_winner.py)
_FUSED_MAX_P = 1024

# ray chunk of the plain twin: bounds its [chunk, P] working set (a few GB
# at P = 450 with every Newton temporary alive)
_REFERENCE_CHUNK_R = 16384

# (ray, block) pairs per chunk of `tile_block_lists`: bounds its dense
# [rays, B, 3] slab tests (one chunk at 512^2 rays x 32 blocks)
_LIST_CHUNK_PAIRS = 1 << 23

_BIG_F = ix._BIG


# ---------------------------------------------------------------------------
# tables in plain tensor ops: the twins' own, and the plain version of the
# table kernel (cuda_tables.py), which builds them for K1-K3 on the card
# ---------------------------------------------------------------------------


def _seq_sum(x, dim: int):
    """Left-to-right sum along `dim` (fixed order, like XLA's reduce loop)."""
    parts = x.unbind(dim)
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


def _norm3(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def patch_spheres(patches: BezierPatches):
    """Per-patch bounding sphere over the control net (surface inside the
    convex hull of the 10 control points), inflated 25%: (center [P,3],
    radius [P]).  The inflation is empirical; see the JAX package's
    patch_spheres for the measurements behind it."""
    cp = patches.control_points
    # a true division (a Python scalar divisor would multiply by 1/10)
    center = _seq_sum(cp, 1) / torch.full_like(cp[:, 0, :], 10.0)
    radius = _norm3(cp - center[:, None, :]).amax(dim=-1) * 1.25 + 1e-5
    return center, radius


def _patch_boxes(cp, center, radius):
    """Per-patch AABB: control-net box expanded per axis by the sphere's
    slack (radius - r_hull).  Padding rows are excluded downstream by their
    radius 0."""
    r_hull = _norm3(cp - center[:, None, :]).amax(dim=-1)
    slack = (radius - r_hull).clamp_min(0.0)[:, None]
    return cp.amin(dim=1) - slack, cp.amax(dim=1) + slack


def patch_box_table(patches: BezierPatches, spheres=None) -> torch.Tensor:
    """[P_pad, 8] f32 per-patch boxes of K1's per-pair test (`_patch_boxes`:
    lo xyz, hi xyz, 2 zero columns); padding rows all zero.  spheres:
    `patch_spheres(patches)`, where the caller has them already."""
    center, radius = patch_spheres(patches) if spheres is None else spheres
    P = patches.num_patches
    lo, hi = _patch_boxes(patches.control_points, center, radius)
    rows = torch.cat([lo, hi, lo.new_zeros((P, 2))], dim=-1).to(torch.float32)
    return _pad_rows(rows, P + (-P) % _PATCH_PAD).contiguous()


def _ray_aabb_hit(lo, hi, s, d):
    """Slab test: do rays (s, d) [R,3] hit boxes [B,3]?  Returns [R,B] bool.
    Zero direction components become +-1e-30 so the slab arithmetic stays
    finite with the exact parallel-ray semantics."""
    d_safe = torch.where(d.abs() < 1e-30, torch.where(d < 0.0, -1e-30, 1e-30), d)
    inv = 1.0 / d_safe                                          # [R,3]
    t1 = (lo[None, :, :] - s[:, None, :]) * inv[:, None, :]     # [R,B,3]
    t2 = (hi[None, :, :] - s[:, None, :]) * inv[:, None, :]
    tmin = torch.minimum(t1, t2).amax(dim=-1)                   # [R,B]
    tmax = torch.maximum(t1, t2).amin(dim=-1)
    return (tmax >= 0.0) & (tmin <= tmax)


def _block_spheres_cr(center, radius, block_p: int = BLOCK_P):
    """Merged sphere per block_p-patch block from per-patch (center [Pp,3],
    radius [Pp]) whose row count is a block_p multiple; padding rows have
    radius <= 0.  Returns ([B,3], [B]) with radius < 0 for all-padding
    blocks."""
    cb = center.reshape(-1, block_p, 3)
    rb = radius.reshape(-1, block_p)
    real = rb > 0.0
    denom = real.sum(dim=1).clamp_min(1).to(torch.float32)
    c = _seq_sum(torch.where(real[..., None], cb, 0.0), 1) / denom[:, None]
    reach = _norm3(cb - c[:, None, :]) + rb
    return c, torch.where(real, reach, -1.0).amax(dim=1)


def _pad_rows(x, rows: int):
    return torch.cat([x, x.new_zeros((rows - x.shape[0],) + x.shape[1:])])


# columns of the [B, 12] block-bounds table (`block_bounds`): centre 0-2
_BND_RADIUS, _BND_LO, _BND_HI = 3, 4, 7
_N_BOUNDS = 12


def block_bounds(patches: BezierPatches, block_p: int = BLOCK_P, spheres=None):
    """[B, 12] f32 per block_p-patch block of the padded table (B = P_pad /
    block_p): merged sphere centre xyz and radius (cols 0-3, radius < 0 for
    an all-padding block), union of the patches' AABBs lo xyz (4-6) and hi
    xyz (7-9), 2 zero pad columns.  The one table every cull reads: the
    kernels' own (csrc/block_walk.cuh), `tile_block_lists` and
    `tile_bitmap_reference`.  spheres: `patch_spheres(patches)`, where the
    caller has them already."""
    center, radius = patch_spheres(patches) if spheres is None else spheres
    P = patches.num_patches
    P_pad = P + (-P) % _PATCH_PAD
    lo, hi = _patch_boxes(patches.control_points, center, radius)
    center, radius = _pad_rows(center, P_pad), _pad_rows(radius, P_pad)
    lo, hi = _pad_rows(lo, P_pad), _pad_rows(hi, P_pad)
    c, r = _block_spheres_cr(center, radius, block_p)
    real = (radius > 0.0).reshape(-1, block_p)[..., None]           # [B, block_p, 1]
    lob = torch.where(real, lo.reshape(-1, block_p, 3), torch.inf).amin(dim=1)
    hib = torch.where(real, hi.reshape(-1, block_p, 3), -torch.inf).amax(dim=1)
    return torch.cat([c, r[:, None], lob, hib, c.new_zeros((c.shape[0], 2))],
                     dim=-1).to(torch.float32).contiguous()


def tile_block_lists(patches: BezierPatches, rays_t, block_p: int = BLOCK_P,
                     use_aabb: bool = True):
    """Per-128-ray-tile candidate block lists, the JAX package's
    (`pallas_sweep.tile_block_lists`), from `block_bounds`.

    rays_t [8, R_pad] (rows sx, sy, sz, dx, dy, dz, 0, 0).  Returns
    (counts [T] i32, lists [B, T] i32) with B = P_pad / block_p:
    lists[:counts[t], t] are the ids of the blocks whose merged sphere AND
    union-of-patch-AABBs are hit by at least one ray of tile t, ascending.
    use_aabb=False drops the AABB leg (the sphere-only cull, for the bench's
    cull A/B).  A dense [rays, B] test in chunks of whole tiles (about
    _LIST_CHUNK_PAIRS ray-block pairs each), then a stable sort.  The plain
    twins read their lists here; K1, K2 and K3 cull inside the kernel."""
    bounds = block_bounds(patches, block_p)
    c, r = bounds[:, :3], bounds[:, _BND_RADIUS]
    lob, hib = bounds[:, _BND_LO:_BND_LO + 3], bounds[:, _BND_HI:_BND_HI + 3]
    B = c.shape[0]
    r2 = (r * r)[None, :]
    chunk = max(1, _LIST_CHUNK_PAIRS // (B * TILE_R)) * TILE_R
    tile_hit = []
    for r0 in range(0, rays_t.shape[1], chunk):
        s = rays_t[0:3, r0:r0 + chunk].T                # [rc, 3]
        d = rays_t[3:6, r0:r0 + chunk].T
        rel = c[None, :, :] - s[:, None, :]             # [rc, B, 3]
        t_ca = (rel[..., 0] * d[:, None, 0] + rel[..., 1] * d[:, None, 1]
                + rel[..., 2] * d[:, None, 2])
        rel2 = rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1] + rel[..., 2] * rel[..., 2]
        hit = ((rel2 - t_ca * t_ca) <= r2) & ((t_ca >= 0.0) | (rel2 <= r2))
        hit = hit & (r >= 0.0)[None, :]                 # all-padding blocks
        if use_aabb:
            hit = hit & _ray_aabb_hit(lob, hib, s, d)
        tile_hit.append(hit.reshape(-1, TILE_R, B).any(dim=1))      # [tc,B]
    tile_hit = torch.cat(tile_hit)
    counts = tile_hit.sum(dim=-1).to(torch.int32)
    lists = torch.argsort((~tile_hit).to(torch.uint8), dim=-1, stable=True)
    return counts, lists.T.contiguous().to(torch.int32)


def tile_bitmap_reference(bounds, rays_t, use_aabb: bool = True):
    """Plain version of the kernels' in-kernel cull (csrc/block_walk.cuh
    cull_tile): bounds [B, 12] (`block_bounds`), rays_t [8, R_pad] ->
    [T, B] bool, block b listed for tile t.  The kernel's expressions in its
    order, one (ray, block) at a time: the sphere test, then the slab test
    with one reciprocal per ray and axis and the min/max folded over x, y,
    z.  Equal to `listed_blocks(*tile_block_lists(...))`; rays go in chunks
    of whole tiles."""
    B = bounds.shape[0]
    chunk = max(1, _LIST_CHUNK_PAIRS // (B * TILE_R)) * TILE_R
    b = [bounds[None, :, k] for k in range(_N_BOUNDS)]               # [1, B] each
    tiles = []
    for r0 in range(0, rays_t.shape[1], chunk):
        sx, sy, sz, dx, dy, dz = (rays_t[k, r0:r0 + chunk, None] for k in range(6))
        relx, rely, relz = b[0] - sx, b[1] - sy, b[2] - sz
        t_ca = relx * dx + rely * dy + relz * dz
        rel2 = relx * relx + rely * rely + relz * relz
        r2 = b[3] * b[3]
        hit = ((rel2 - t_ca * t_ca) <= r2) & ((t_ca >= 0.0) | (rel2 <= r2)) & (b[3] >= 0.0)
        if use_aabb:
            near = far = None
            for axis, (s, d) in enumerate(((sx, dx), (sy, dy), (sz, dz))):
                d_safe = torch.where(d.abs() < 1e-30,
                                     torch.where(d < 0.0, -1e-30, 1e-30), d)
                inv = 1.0 / d_safe
                t1 = (b[_BND_LO + axis] - s) * inv
                t2 = (b[_BND_HI + axis] - s) * inv
                lo_t, hi_t = torch.minimum(t1, t2), torch.maximum(t1, t2)
                near = lo_t if near is None else torch.maximum(near, lo_t)
                far = hi_t if far is None else torch.minimum(far, hi_t)
            hit = hit & (far >= 0.0) & (near <= far)
        tiles.append(hit.reshape(-1, TILE_R, B).any(dim=1))
    return torch.cat(tiles)


def pack_patch_table(patches: BezierPatches, spheres=None) -> torch.Tensor:
    """Row-major [P_pad, 64] f32 feature table (layout: the _ROW_* columns);
    padding rows are all zero (zero normal -> WHAT_NONE, radius 0 -> never
    listed).  spheres: `patch_spheres(patches)`, where the caller has them
    already."""
    P = patches.num_patches
    center, radius = patch_spheres(patches) if spheres is None else spheres
    rows = torch.cat(
        [
            patches.control_points.reshape(P, 30),
            patches.underlying,
            patches.bary_inverse.reshape(P, 9),
            patches.heights,
            patches.deriv_b,
            patches.dividers.reshape(P, 12),
            center,
            radius[:, None],
        ],
        dim=-1,
    ).to(torch.float32)
    return _pad_rows(rows, P + (-P) % _PATCH_PAD).contiguous()


def pad_rays(start, direction) -> torch.Tensor:
    """[8, R_pad] f32 ray table (rows sx, sy, sz, dx, dy, dz, 0, 0), R padded
    to a TILE_R multiple with rays s = 0, d = (1, 0, 0)."""
    R = start.shape[0]
    R_pad = R + (-R) % TILE_R
    rays = torch.zeros((R_pad, 8), dtype=torch.float32, device=start.device)
    rays[:R, 0:3] = start
    rays[:R, 3:6] = direction
    rays[R:, 3] = 1.0
    return rays.T.contiguous()


def sphere_hit_pairs(patch_t, rays_t):
    """Per-(ray, patch) bounding-sphere test [R, P_pad] over the packed table
    (the expression csrc/candidate.cuh::patch_sphere_hit evaluates)."""
    bc = patch_t[:, _ROW_BSPHERE:_ROW_BSPHERE + 4]
    sx, sy, sz = (rays_t[k, :, None] for k in range(3))
    dx, dy, dz = (rays_t[k, :, None] for k in range(3, 6))
    relx, rely, relz = bc[:, 0] - sx, bc[:, 1] - sy, bc[:, 2] - sz
    t_ca = relx * dx + rely * dy + relz * dz
    rel2 = relx * relx + rely * rely + relz * relz
    r2 = bc[:, 3] * bc[:, 3]
    return ((rel2 - t_ca * t_ca) <= r2) & ((t_ca >= 0.0) | (rel2 <= r2))


def box_hit_pairs(boxes, rays_t):
    """Per-(ray, patch) box test [R, P_pad] over the per-patch boxes [P_pad,
    8] (`patch_box_table`): the slab test K1 evaluates on each pair
    (csrc/sweep_select.cu patch_box_hit, block_walk.cuh's block test on the
    patch's own box)."""
    return _ray_aabb_hit(boxes[:, 0:3], boxes[:, 3:6], rays_t[0:3].T, rays_t[3:6].T)


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------


def sweep_select_reference(patches: BezierPatches, start, direction,
                           cull: bool = True, use_aabb: bool = True,
                           block_p: int = BLOCK_P, half_gate: bool = False,
                           prior=None):
    """Plain PyTorch version of K1: (any_hit [R], win [R] i32, win_dist [R]).

    cull=True computes the kernel's function: per-pair `_candidates_core`
    codes in the mode config asks for (`intersect.sweep_mode()`), pairs
    outside the listed-and-gated (tile x block, or x half-block with
    half_gate) set `gated_pairs` forced to WHAT_NONE, then
    `select_candidates`; use_aabb and block_p as in `tile_block_lists`.
    Under `profiling.counting()` it counts the pairs the kernel's first
    pass evaluates (`evaluated_pairs`), which give the same winners.
    cull=False is exact `sweep_codes` followed by `select_candidates` over
    every pair (the JAX package's XLA path, which no mode reaches).  Rays
    are processed in chunks of _REFERENCE_CHUNK_R.  prior: as in
    `sweep_select` (`with_prior`): the tiles with a live ray are searched,
    the others return it."""
    R = start.shape[0]
    P = patches.num_patches
    start = start.to(torch.float32)
    direction = direction.to(torch.float32)
    check_half_gate(half_gate, block_p, cull)
    if prior is not None:
        return with_prior(lambda s, d: sweep_select_reference(
            patches, s, d, cull, use_aabb, block_p, half_gate), start, direction, prior)
    if not cull:
        outs = [
            ix.select_candidates(
                *ix.sweep_codes(patches, start[r0:r0 + _REFERENCE_CHUNK_R],
                                direction[r0:r0 + _REFERENCE_CHUNK_R]),
                patches.neighbours,
            )
            for r0 in range(0, R, _REFERENCE_CHUNK_R)
        ]
        return tuple(torch.cat(o) for o in zip(*outs))

    rays_t = pad_rays(start, direction)
    patch_t = pack_patch_table(patches)
    listed = listed_blocks(*tile_block_lists(patches, rays_t, block_p, use_aabb),
                           patch_t.shape[0], block_p)
    boxes = patch_box_table(patches) if profiling.counting_enabled() else None

    mode = ix.sweep_mode()
    tiles_per_chunk = _REFERENCE_CHUNK_R // TILE_R
    outs = []
    for t0 in range(0, listed.shape[0], tiles_per_chunk):
        rt = rays_t[:, t0 * TILE_R:(t0 + tiles_per_chunk) * TILE_R]
        lt, sphere = listed[t0:t0 + tiles_per_chunk], sphere_hit_pairs(patch_t, rt)
        keep = gated_pairs(lt, sphere, block_p, half_gate)[:, :P]
        if boxes is not None:
            count_twin_pairs("sweep_select", evaluated_pairs(
                lt, sphere, box_hit_pairs(boxes, rt), block_p)[:, :P])
        code, dist = ix.sweep_codes(patches, rt[0:3].T, rt[3:6].T, mode)
        code = torch.where(keep, code, ix.WHAT_NONE)
        outs.append(ix.select_candidates(code, dist, patches.neighbours))
    return tuple(torch.cat(o)[:R] for o in zip(*outs))


def check_prior(prior, R: int, device) -> None:
    """Raise unless `prior` (an `intersect.WinnerPrior`) holds R rays: live
    flags (bool), winners (i32) and distances (f32), contiguous, on
    `device`."""
    for t, name, dtype in ((prior.live, "live", torch.bool), (prior.win, "win", torch.int32),
                           (prior.dist, "dist", torch.float32)):
        cuda_lib.check_tensor(t, f"prior.{name}", dtype, (R,), device)


def with_prior(search, start, direction, prior):
    """K1's answer with a prior, in plain tensor ops: `search(start,
    direction)` -> (any_hit, win, dist) on the rays of the 128-ray tiles
    that hold a live ray, taken whole and in order (so each keeps its
    tile), and the prior's win and dist on every other ray; under
    `profiling.counting()` the reused and the searched tiles counted as K1
    counts them (`reuse_counts`)."""
    R = start.shape[0]
    check_prior(prior, R, start.device)
    T = -(-R // TILE_R)
    live = torch.zeros(T * TILE_R, dtype=torch.bool, device=start.device)
    live[:R] = prior.live
    tiles = torch.nonzero(live.reshape(T, TILE_R).any(dim=1))[:, 0]
    rays = (tiles[:, None] * TILE_R
            + torch.arange(TILE_R, device=start.device)[None, :]).reshape(-1)
    rays = rays[rays < R]
    win, dist = prior.win.clone(), prior.dist.clone()
    if rays.numel():
        _, win[rays], dist[rays] = search(start[rays], direction[rays])
    if profiling.counting_enabled():
        _add_reuse(torch.tensor([T - tiles.shape[0], T], dtype=torch.int64,
                                device=start.device))
    return dist < _BIG_F * 0.5, win, dist


def listed_blocks(counts, lists, P_pad: int, block_p: int = BLOCK_P):
    """[T, B] bool: block b is on tile t's list (from `tile_block_lists` at
    the same block_p)."""
    B = P_pad // block_p
    T = counts.shape[0]
    slot = torch.arange(B, device=counts.device)[:, None]          # [B,1]
    listed = torch.zeros((T, B), dtype=torch.bool, device=counts.device)
    listed[torch.arange(T, device=counts.device).expand(B, T)[slot < counts],
           lists.long()[slot < counts]] = True
    return listed


def check_half_gate(half_gate: bool, block_p: int, cull: bool = True):
    """Raise unless half_gate can apply: the JAX package gates halves of
    blocks of at least 16 patches, and only on its culled kernel."""
    if half_gate and (block_p < 16 or block_p % 2 or not cull):
        raise ValueError(f"half_gate takes a culled K1 at an even block_p >= 16, "
                         f"got block_p = {block_p}, cull = {cull}")


def gated_pairs(listed, sphere, block_p: int = BLOCK_P, half_gate: bool = False):
    """The (ray, patch) pairs of the gated units: those of blocks listed for
    the ray's tile AND gated, i.e. some (patch, ray) pair of block x tile
    passes the sphere test; with half_gate (K1's option) each half of a
    listed block (block_p / 2 patches) is gated on its own.  K2 and K3
    evaluate these pairs; in K1 they are the pairs whose codes count (its
    retries are those of gated units), and its first pass evaluates the
    subset `evaluated_pairs`.  listed [tc, B] (B = P_pad / block_p), sphere
    [tc*TILE_R, P_pad] (`sphere_hit_pairs`) -> [tc*TILE_R, P_pad] bool."""
    tc, B = listed.shape
    unit = block_p // 2 if half_gate else block_p
    units = B * block_p // unit
    gated = sphere.reshape(tc, TILE_R, units, unit).any(dim=3).any(dim=1)    # [tc, units]
    listed = listed.repeat_interleave(block_p // unit, dim=1)
    return (listed & gated)[:, None, :, None].expand(
        tc, TILE_R, units, unit).reshape(tc * TILE_R, units * unit)


def evaluated_pairs(listed, sphere, box, block_p: int = BLOCK_P):
    """The (ray, patch) pairs K1's first pass evaluates: listed for the
    ray's tile, gated (`gated_pairs`, with or without the half gate) and
    passing the pair's own sphere and box tests.  A pair that passes the
    sphere test opens its unit's gate, so this is listed AND sphere AND box
    whatever the unit.  listed [tc, B], sphere and box [tc*TILE_R, P_pad]
    (`sphere_hit_pairs`, `box_hit_pairs`) -> [tc*TILE_R, P_pad] bool."""
    tc, B = listed.shape
    listed = listed[:, None, :, None].expand(tc, TILE_R, B, block_p).reshape(sphere.shape)
    return listed & sphere & box


# ---------------------------------------------------------------------------
# the kernel: launch
# ---------------------------------------------------------------------------

# cbtr_sweep_select's and cbtr_winner's parameters: 9 pointers (K1 14: the
# boxes after the patch table, the prior's three after the neighbours, the
# reuse counter last; then R, the prior's rays), T, P, P_pad, block_p,
# use_aabb, iterations, 4 tolerances, clamp_secant, the mode
# (`intersect.SweepMode.code`), K1's half_gate, the stream
_ARGS = [ctypes.c_int] * 6 + [ctypes.c_float] * 4 + [ctypes.c_int] * 2
_ENTRY_ARGTYPES = {"sweep_select": [ctypes.c_void_p] * 14 + [ctypes.c_int] + _ARGS
                   + [ctypes.c_int, ctypes.c_void_p],
                   "winner": [ctypes.c_void_p] * 9 + _ARGS + [ctypes.c_void_p]}


def occupancy(stem: str, P_pad: int, mode: int = 0, half_gate: bool = False) -> int:
    """CTAs of K1 ("sweep_select") or K2 ("winner") one SM holds at a table
    of P_pad rows, for the instantiation of `mode` (`intersect.SweepMode.code`)
    and, on K1, half_gate: the device's answer for the build's registers and
    the launch's shared memory (a negative CUDA error code on failure)."""
    if half_gate and stem != "sweep_select":
        raise ValueError("half_gate is K1's option")
    args = (P_pad, BLOCK_P, mode) + ((int(half_gate),) if stem == "sweep_select" else ())
    return cuda_lib.entry(stem, f"cbtr_{stem}_occupancy", [ctypes.c_int] * len(args))(*args)


@dataclasses.dataclass(frozen=True)
class KernelInputs:
    """Everything one launch of K1 or K2 reads, built by `prepare_inputs`."""

    rays_t: torch.Tensor    # [8, R_pad] f32
    patch_t: torch.Tensor   # [P_pad, 64] f32
    bounds: torch.Tensor    # [P_pad / block_p, 12] f32 (`block_bounds`)
    nb: torch.Tensor        # [P_pad, 3] i32 neighbour ids, -1 on padding
    boxes: torch.Tensor     # [P_pad, 8] f32 (`patch_box_table`), read by K1 only
    num_patches: int
    use_aabb: bool = True   # the cull's AABB leg (`tile_block_lists`)
    block_p: int = BLOCK_P  # patches per candidate block (the bounds' rows)


@dataclasses.dataclass(frozen=True)
class KernelOutputs:
    """What one launch of K1 or K2 writes (`launch`)."""

    dist: torch.Tensor      # [R_pad] f32 winning distance, BIG (3.4e38) on a miss
    win: torch.Tensor       # [R_pad] i32 winning patch, 0 on a miss
    counts: torch.Tensor    # [T] i32 blocks the tile's cull listed
    lists: torch.Tensor | None = None   # [B, T] i32: lists[:counts[t], t] ascending
    pairs: torch.Tensor | None = None   # [T, 2] i32: pass-1 pairs, retries evaluated


def check_tables(tables, patches: BezierPatches, block_p: int, clamped: bool):
    """Raise unless `tables` (a `cuda_tables.PatchTables`) are these patches'
    tables at block_p, with the neighbours clamped or not as the kernel
    reads them (K2: clamped), on the patches' device."""
    if (tables.num_patches, tables.block_p, tables.clamped) != (
            patches.num_patches, block_p, clamped) or tables.patch_t.device != patches.device:
        raise ValueError(
            f"tables of {tables.num_patches} patches at block {tables.block_p} "
            f"(clamped={tables.clamped}) on {tables.patch_t.device}; this kernel takes "
            f"{patches.num_patches} at block {block_p} (clamped={clamped}) on "
            f"{patches.device}")


def _inputs(patches: BezierPatches, start, direction, use_aabb: bool, block_p: int,
            tables, clamped: bool) -> KernelInputs:
    """K1's (clamped False) or K2's (clamped True) `KernelInputs`: the rays
    packed (`cuda_tables.pack_rays`) and the given tables, or tables built
    here (`cuda_tables.build_tables`)."""
    from . import cuda_tables       # it imports this module for the plain versions

    device = start.device
    if patches.device != device or direction.device != device:
        raise ValueError("patches, start and direction must share one device")
    if tables is None:
        tables = cuda_tables.build_tables(patches, block_p, clamp=clamped)
    else:
        check_tables(tables, patches, block_p, clamped)
    rays_t = cuda_tables.pack_rays(start.to(torch.float32).contiguous(),
                                   direction.to(torch.float32).contiguous())
    return KernelInputs(rays_t, tables.patch_t, tables.bounds, tables.nb, tables.boxes,
                        patches.num_patches, use_aabb, block_p)


def prepare_inputs(patches: BezierPatches, start, direction,
                   use_aabb: bool = True, block_p: int = BLOCK_P,
                   tables=None) -> KernelInputs:
    """The kernel's tables on the rays' device: the rays
    (`cuda_tables.pack_rays`: one launch of the ray-pack kernel on the
    card, `pad_rays` on the CPU); patch table, block bounds, neighbours and
    per-patch boxes from `tables` (a `cuda_tables.PatchTables` of these patches at block_p,
    unclamped), or, where none are given, from `cuda_tables.build_tables`
    (the table kernel on the card, the plain versions on the CPU); use_aabb
    and block_p as in `tile_block_lists` (the main path runs BLOCK_P; 32 is
    the JAX package's block above its ray cap, for comparisons).  No lists:
    the kernels cull for themselves."""
    return _inputs(patches, start, direction, use_aabb, block_p, tables, False)


def check_inputs(inputs: KernelInputs, kernel: str):
    """Raise unless `inputs` are tables a kernel takes: CUDA tensors of the
    shapes, types and layout `prepare_inputs` gives.  Returns (T, P_pad)."""
    device = inputs.rays_t.device
    R_pad, P_pad = inputs.rays_t.shape[-1], inputs.patch_t.shape[0]
    if R_pad % TILE_R or P_pad % _PATCH_PAD or not 0 < inputs.num_patches <= P_pad \
            or _PATCH_PAD % inputs.block_p:
        raise ValueError(f"unsupported shape: P = {inputs.num_patches}, "
                         f"R_pad = {R_pad}, P_pad = {P_pad}, block_p = {inputs.block_p}")
    tables = [
        (inputs.rays_t, "rays_t", torch.float32, (8, R_pad)),
        (inputs.patch_t, "patch_t", torch.float32, (P_pad, _N_ROWS)),
        (inputs.bounds, "bounds", torch.float32, (P_pad // inputs.block_p, _N_BOUNDS)),
        (inputs.nb, "neighbours", torch.int32, (P_pad, 3)),
    ]
    if kernel == "K1":
        tables.append((inputs.boxes, "boxes", torch.float32, (P_pad, _N_BOX)))
    for t, name, dtype, shape in tables:
        cuda_lib.check_tensor(t, name, dtype, shape, device)
    if device.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors, got {device}; on the "
                         "CPU its plain twin computes the same function")
    return R_pad // TILE_R, P_pad


def launch_kernel(stem: str, inputs: KernelInputs, lists: bool = False,
                  pairs: bool = False, half_gate: bool = False,
                  prior=None) -> KernelOutputs:
    """One launch of K1 (stem "sweep_select") or K2 ("winner") on the current
    stream over tables from `prepare_inputs`, in the mode config asks for
    (`intersect.sweep_mode()`).  lists / pairs also fill the per-tile lists
    and pair counts (for checks; the main path asks for neither); half_gate
    and prior (an `intersect.WinnerPrior` of the first R rays, R within the
    last tile: a tile with no live ray writes its answer, counts 0 blocks
    and 0 pairs, and its padding rays read a miss) are K1's options.
    `cuda_lib.call` launches and counts it (as "sweep_select" or "winner");
    while `profiling.counting()` is on it fills the pair counts whether
    asked or not and adds them to the kernel's accumulator on the device
    (`pair_counts`), and K1 its reused and prior-launched tiles to
    `reuse_counts`' accumulator."""
    T, P_pad = check_inputs(inputs, "K1" if stem == "sweep_select" else "K2")
    k1 = stem == "sweep_select"
    if (half_gate or prior is not None) and not k1:
        raise ValueError("half_gate and the prior are K1's options")
    check_half_gate(half_gate, inputs.block_p)
    device, R_pad, B = inputs.rays_t.device, T * TILE_R, P_pad // inputs.block_p
    R = R_pad if prior is None else prior.live.shape[0]
    if prior is not None:
        if -(-R // TILE_R) != T:
            raise ValueError(f"a prior of {R} rays for a launch of {T} tiles")
        check_prior(prior, R, device)
    counted = profiling.counting_enabled()
    pairs = pairs or counted
    reuse = torch.zeros(2, dtype=torch.int32, device=device) \
        if counted and prior is not None else None
    out = KernelOutputs(
        dist=torch.empty(R_pad, dtype=torch.float32, device=device),
        win=torch.empty(R_pad, dtype=torch.int32, device=device),
        counts=torch.empty(T, dtype=torch.int32, device=device),
        lists=torch.full((B, T), -1, dtype=torch.int32, device=device) if lists else None,
        pairs=torch.zeros((T, 2), dtype=torch.int32, device=device) if pairs else None)

    options = (ix.sweep_mode().code,) + ((int(half_gate),) if k1 else ())
    given = (None,) * 3 if prior is None else tuple(t.data_ptr() for t in prior)
    cuda_lib.call(
        stem, _ENTRY_ARGTYPES[stem], device,
        inputs.rays_t.data_ptr(), inputs.patch_t.data_ptr(),
        *((inputs.boxes.data_ptr(),) if k1 else ()),
        inputs.bounds.data_ptr(), inputs.nb.data_ptr(), *(given if k1 else ()),
        out.dist.data_ptr(), out.win.data_ptr(), out.counts.data_ptr(),
        out.lists.data_ptr() if lists else None,
        out.pairs.data_ptr() if pairs else None,
        *((None if reuse is None else reuse.data_ptr(), R) if k1 else ()),
        T, inputs.num_patches, P_pad, inputs.block_p, int(inputs.use_aabb),
        int(CFG.root_search_iterations),
        CFG.ray_plane_intersection_epsilon,
        CFG.intersection_estimation_epsilon,
        CFG.max_intersection_distance_from_ray,
        CFG.minimal_ray_distance,
        int(CFG.clamp_secant_estimate),
        *options,
    )
    if counted:
        _add_pairs(stem, out.pairs.sum(dim=0, dtype=torch.int64))
        if reuse is not None:
            _add_reuse(reuse.to(torch.int64))
    return out


def launch(inputs: KernelInputs, lists: bool = False, pairs: bool = False,
           half_gate: bool = False, prior=None) -> KernelOutputs:
    """One launch of K1 (`launch_kernel`); at most _FUSED_MAX_P patches."""
    if inputs.num_patches > _FUSED_MAX_P:
        raise ValueError(f"K1 takes at most {_FUSED_MAX_P} patches, got "
                         f"{inputs.num_patches}")
    return launch_kernel("sweep_select", inputs, lists, pairs, half_gate, prior)


def sweep_select(patches: BezierPatches, start, direction, use_aabb: bool = True,
                 tables=None, half_gate: bool = False, prior=None):
    """K1 wrapper: (any_hit [R] bool, win [R] i32, win_dist [R] f32).

    CPU tensors go to `sweep_select_reference` (cull=True); CUDA tensors
    launch csrc/sweep_select.cu; both in the mode config asks for
    (`intersect.sweep_mode()`); use_aabb as in `tile_block_lists`;
    half_gate as in `gated_pairs` (off on every path of the port);
    tables: the patches' `cuda_tables.PatchTables` at BLOCK_P, where the
    caller built them (`prepare_inputs` builds them otherwise; the twin
    checks them and builds its own); prior: an `intersect.WinnerPrior` of
    these R rays, or None (the module's docstring).  There is no fallback
    between the two: a build or launch failure raises, and so does P >
    _FUSED_MAX_P on the GPU (`intersect_rays` sends that range to K2,
    cuda_winner.sweep_winner)."""
    R = start.shape[0]
    if prior is not None:
        check_prior(prior, R, start.device)
    if not start.is_cuda:
        if tables is not None:
            check_tables(tables, patches, BLOCK_P, False)
        return sweep_select_reference(patches, start, direction, use_aabb=use_aabb,
                                      half_gate=half_gate, prior=prior)
    out = launch(prepare_inputs(patches, start, direction, use_aabb, tables=tables),
                 half_gate=half_gate, prior=prior)
    best = out.dist[:R]
    return best < _BIG_F * 0.5, out.win[:R], best


# K1's and K2's pass-1 pairs and retries, int64 [2] on the device, added
# while `profiling.counting()` is on (`pair_counts`); None: none counted
_counted = dict.fromkeys(("sweep_select", "winner"))
# K1's tiles that returned the prior and tiles launched with one, int64 [2]
# on the device, added while `profiling.counting()` is on (`reuse_counts`)
_reused = None


def _add_pairs(stem: str, pairs) -> None:
    """Add int64 [2] (pass-1 pairs, retries) to the kernel's accumulator,
    on its device, reading nothing back."""
    if _counted[stem] is None:
        _counted[stem] = pairs.clone()
    else:
        _counted[stem].add_(pairs)


def count_twin_pairs(stem: str, keep) -> None:
    """While `profiling.counting()` is on, add a plain twin's evaluated
    pairs (`keep`: K1's `evaluated_pairs`, K2's `gated_pairs`) as pass-1
    pairs of `stem`; the twins count no retries."""
    if profiling.counting_enabled():
        total = keep.sum(dtype=torch.int64)
        _add_pairs(stem, torch.stack((total, torch.zeros_like(total))))


def pair_counts() -> dict:
    """{stem: (pass-1 pairs, retries)} added while `profiling.counting()`
    was on since the last `reset_pair_counts`, each read once; (0, 0) for
    a kernel that counted none."""
    return {stem: (0, 0) if p is None else tuple(int(x) for x in p.tolist())
            for stem, p in _counted.items()}


def _add_reuse(tiles) -> None:
    """Add int64 [2] (tiles reused, tiles launched with a prior) to K1's
    reuse accumulator, on its device, reading nothing back."""
    global _reused
    _reused = tiles.clone() if _reused is None else _reused.add_(tiles)


def reuse_counts() -> tuple:
    """(tiles that returned the prior, tiles launched with one) by K1 and its
    twin while `profiling.counting()` was on since the last
    `reset_pair_counts`, read once; (0, 0) where none was."""
    return (0, 0) if _reused is None else tuple(int(x) for x in _reused.tolist())


def reset_pair_counts() -> None:
    """Clear the pair counters and K1's reuse counter."""
    global _reused
    for stem in _counted:
        _counted[stem] = None
    _reused = None

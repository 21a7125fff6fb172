"""Snell refraction at a Bezier lens surface.

Counterpart of cbtr_tpu/optics/lens.py: a branch-free batched re-design of
BezierLens::refract (reference/bezierLens.cpp:4-34).  The if/else ladder
(miss / TIR / grazing pass-through / refraction) becomes masks over a ray
batch; a candidate refraction survives only if the inside/outside
transition matches what the caller expects (reference/README.md:155).

Status codes follow the reference enum (reference/bezierLens.h:7-11).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import geom
from ..config import DEFAULT as CFG
from ..ops.intersect import WHAT_INTERSECT, WinnerPrior, intersect_rays, winner_tables
from ..utils.profiling import backward_span, span

REFRACT_NONE = 0
REFRACT_INSIDE = 1
REFRACT_OUTSIDE = 2


def _index_pair(refractive_index, device):
    """(1 / n, n) in f32 for the entering and the leaving side.  A Python
    number stays a pair of Python floats, rounded on the host as the card
    rounds them (n to f32, then the correctly rounded f32 quotient), so
    that no host-to-device copy waits for the stream; anything else is an
    f32 tensor on `device`."""
    if isinstance(refractive_index, (int, float)):
        n = np.float32(refractive_index)
        return float(np.float32(1.0) / n), float(n)
    ri = torch.as_tensor(refractive_index, dtype=torch.float32, device=device)
    return 1.0 / ri, ri


@span("cbtr.refract")
@backward_span("cbtr.backward.refract")
def refract_rays(patches, refractive_index, start, direction, expected,
                 chunk_size: int = 0, backend: str = "auto", intersect_fn=None,
                 tables=None, prior=None, winners=None):
    """Refract a ray batch at the lens surface.

    expected: int (REFRACT_INSIDE or REFRACT_OUTSIDE) or [...] i32 tensor.
    Returns (new_start [...,3], new_direction [...,3], status [...] i32).
    Rays whose status is REFRACT_NONE are dead (miss / TIR / unexpected
    transition); their outputs carry the inputs unchanged so downstream
    passes stay finite.

    intersect_fn: optional (patches, start, direction) -> RayHit in place of
    `intersect_rays` (chunk_size and backend then go unused), so a sharded
    intersection (parallel.patch_parallel.intersect_rays_patch_sharded)
    reuses this Snell physics.

    tables: the winner kernel's tables of `patches`
    (`ops.intersect.winner_tables`) where the caller built them; otherwise
    `intersect_rays` builds them.  Unused with intersect_fn.

    prior, winners: `intersect_rays`' (K1's prior for this search, a list
    for K1's answers); unused with intersect_fn.
    """
    if intersect_fn is None:
        hit = intersect_rays(patches, start, direction, chunk_size=chunk_size,
                             backend=backend, tables=tables, prior=prior, winners=winners)
    else:
        hit = intersect_fn(patches, start, direction)
    ok = hit.what == WHAT_INTERSECT

    cos_inc = hit.cos_incidence
    # ray from outside has cos < 0 (normal points outwards)
    going_in = cos_inc < 0.0
    status = torch.where(going_in, REFRACT_INSIDE, REFRACT_OUTSIDE)
    eff = torch.where(going_in, *_index_pair(refractive_index, cos_inc.device))
    sin2 = eff * eff * (1.0 - cos_inc * cos_inc)

    tir = sin2 >= CFG.max_sin2_refraction
    grazing = sin2 <= CFG.min_sin2_refraction

    normal = hit.normal * torch.where(going_in, 1.0, -1.0)[..., None]
    cos1 = cos_inc.abs()
    # TIR lanes would evaluate sqrt at 0 whose backward is inf (a 0
    # cotangent times inf is NaN in the refractive-index gradient); they are
    # masked out below, so substitute a tame argument.  Surviving lanes have
    # 1 - sin2 >= 1 - max_sin2 = 0.01, far above the floor.
    sin2_live = torch.where(tir, 0.0, sin2)
    cos2 = torch.sqrt((1.0 - sin2_live).clamp_min(1e-6))
    bent = geom.safe_normalize(
        direction * eff[..., None] + normal * (eff * cos1 - cos2)[..., None]
    )
    new_dir = torch.where(grazing[..., None], direction, bent)

    status = torch.where(ok & ~tir, status, REFRACT_NONE)
    if not isinstance(expected, int):
        expected = torch.as_tensor(expected, dtype=status.dtype, device=status.device)
    status = torch.where(status == expected, status, REFRACT_NONE)

    alive = (status != REFRACT_NONE)[..., None]
    new_start = torch.where(alive, hit.point, start)
    new_dir = torch.where(alive, new_dir, direction)
    return new_start, new_dir, status.to(torch.int32)


def trace_through_lens(patches, refractive_index, start, direction,
                       chunk_size: int = 0, backend: str = "auto",
                       intersect_fn=None):
    """Full lens pass: refract entering (expect inside), then exiting
    (expect outside) — the per-ray state machine of the reference's
    illumination loop (reference/test.cpp:376-394).  intersect_fn: see
    `refract_rays`.  Both refractions meet the same patches, so the winner
    kernel's tables are built once here (`ops.intersect.winner_tables`)
    and shared by both and by every chunk of each.  A ray the first
    refraction leaves dead enters the second as it entered the first, so
    on K1 the second search takes the first's answers as its prior
    (`ops.intersect.WinnerPrior`), and its tiles with no live ray return
    them (`ops.cuda_sweep`).

    Returns (start, direction, alive_mask, entry_point, exit_point).
    """
    tables = None if intersect_fn is not None else winner_tables(patches, backend)
    first = [] if intersect_fn is None else None
    s1, d1, st1 = refract_rays(
        patches, refractive_index, start, direction, REFRACT_INSIDE,
        chunk_size, backend, intersect_fn, tables, winners=first,
    )
    prior = WinnerPrior(st1.reshape(-1) == REFRACT_INSIDE, *first[0]) if first else None
    s2, d2, st2 = refract_rays(
        patches, refractive_index, s1, d1, REFRACT_OUTSIDE, chunk_size, backend,
        intersect_fn, tables, prior=prior,
    )
    alive = (st1 == REFRACT_INSIDE) & (st2 == REFRACT_OUTSIDE)
    return s2, d2, alive, s1, s2

"""The least time an H100 could take for the winner search of one unit of
work: the roofline that `k1_roofline` and `k2_roofline` read the kernels'
device time against.

Work is counted from the inputs, never from the kernels' own counters: the
(ray, patch) pairs that pass the per-pair candidate test (`pairs.py`) in both
refraction passes, each at PAIR_OPS float32 operations; the second pass
takes the rays that the first leaves alive, as the plain reference refracts
them.  Both are counted on a fixed sample of the unit's rays and scaled to
all of them.  Where larger, the bytes the kernel has to move once set the
bound instead: each ray's start and direction read, its winner written, the
patch table read.

PAIR_OPS is the float32 arithmetic of one candidate evaluation at the 4
fixed Newton iterations, counted by a dispatch mode over the reference's
`tracer.evaluate` (portbench/tests/test_work.py recounts it): each elementwise add,
sub, mul, div, neg, abs, sqrt, maximum and minimum on a float tensor counts
its output's elements.  1566 = 338 + 4 x 307: 338 outside the Newton loop
(the plane hit, the slab gate, the domain gate, the bracket, two surface
differences, the secant, the acceptance and the divider classification)
and 307 in each iteration.  The kernels are built without FMA
contraction, so each counts as one instruction of the float32 pipe; the
peak is NVIDIA's published 67 TFLOP/s all the same.
"""
from __future__ import annotations

import numpy as np
import torch

from .pairs import count_pairs, patch_bounds

PAIR_OPS = 1566
PEAK_F32_OPS_PER_S = 67e12          # H100 SXM, float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
RAY_BYTES = 24                      # start and direction, float32
WINNER_BYTES = 9                    # hit flag, patch id, distance
PATCH_ROW_BYTES = 240               # 60 float32 columns of a patch row
SAMPLE_RAYS = 65536
SAMPLE_SEED = 20260101


def sample_indices(n_rays: int, device) -> torch.Tensor:
    """The fixed sample of a unit's ray indices the work is counted on."""
    if n_rays <= SAMPLE_RAYS:
        return torch.arange(n_rays, device=device)
    idx = np.random.default_rng(SAMPLE_SEED).choice(n_rays, SAMPLE_RAYS, replace=False)
    return torch.as_tensor(np.sort(idx), device=device)


def bound(lens, start, direction, n_rays: int) -> dict:
    """The unit's work and bound.  lens: the reference's `tracer.Lens`;
    start, direction [S,3] float64: the sample of the unit's n_rays rays."""
    from ..reference import tracer

    bounds = patch_bounds(lens.control_points)
    pairs1 = count_pairs(bounds, start, direction)
    with torch.no_grad():
        s1, d1, status, _ = tracer.refract(lens, start, direction, tracer.R_INSIDE)
    alive = status == tracer.R_INSIDE
    pairs2 = count_pairs(bounds, s1[alive], d1[alive])
    scale = n_rays / start.shape[0]
    pairs = (pairs1 + pairs2) * scale
    ops_s = pairs * PAIR_OPS / PEAK_F32_OPS_PER_S
    nbytes = 2 * (n_rays * (RAY_BYTES + WINNER_BYTES)
                  + lens.control_points.shape[0] * PATCH_ROW_BYTES)
    bytes_s = nbytes / PEAK_BYTES_PER_S
    return {"pairs": pairs, "pairs_pass1": pairs1 * scale, "pairs_pass2": pairs2 * scale,
            "ops": pairs * PAIR_OPS, "bytes": nbytes, "bound_s": max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


def unit_bound(traced) -> dict:
    """`bound` of one unit of the traced cell, worked out once per run."""
    state = traced.state
    cached = getattr(state, "_sweep_bound", None)
    if cached is None:
        from ..reference import scene

        lens = scene.build_lens(traced.cell.config, state.mesh, state.device)
        s, d = state.sample_rays(sample_indices(state.n_rays, state.device))
        cached = bound(lens, s.double(), d.double(), state.n_rays)
        state._sweep_bound = cached
    return cached


def roofline_percent(traced, kernel: str):
    """The bound over the kernel's device time a unit, in %; None where the
    kernel did not run in the traced window."""
    ms = traced.kernel_ms([kernel])
    if ms <= 0.0:
        return None
    return 100.0 * unit_bound(traced)["bound_s"] * 1e3 / (ms / traced.units)

"""Frozen copy of `cbtr_tpu_torch/bezier/patches.py` as of the benchmark's first version, for the
plain reference; it imports nothing of the port and is not kept in step with it.

BezierPatches struct-of-tensors + batched evaluation.

Counterpart of cbtr_tpu/bezier/patches.py.  The per-patch state mirrors the
reference's BezierTriangle members (reference/bezierTriangle.h:64-80):

- ``control_points [P,10,3]`` -- cubic control net, index scheme
  300/030/003/210/120/021/012/102/201/111 (reference/bezierTriangle.h:29-51)
- ``neighbours     [P,3] i32`` -- patch ids after the Clough-Tocher split
- ``underlying     [P,4]``     -- plane through control points 0,1,2
- ``dividers       [P,3,4]``   -- neighbour-divider planes, distance >= 0 on
  the patch's own domain (reference/bezierTriangle.h:65-67)
- ``bary_inverse   [P,3,3]``   -- inverse vertex matrix: b = M @ p
- ``heights        [P,2]``     -- sampled (inside<=0, outside>=0) surface
  height over the underlying plane, x safety factor
- ``deriv_b        [P,3]``     -- second directional-derivative direction
  (the first is the constant (1,0,-1)), reference/bezierTriangle.cpp:83-85

The contractions over the 10 control points are unrolled left-to-right sums
(the order of the JAX package and of the CUDA sweep kernel), not matmuls.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class BezierPatches:
    control_points: torch.Tensor  # [P, 10, 3]
    neighbours: torch.Tensor      # [P, 3] i32
    underlying: torch.Tensor      # [P, 4]
    dividers: torch.Tensor        # [P, 3, 4]
    bary_inverse: torch.Tensor    # [P, 3, 3]
    heights: torch.Tensor         # [P, 2] (inside, outside)
    deriv_b: torch.Tensor         # [P, 3]


def _bernstein(b0, b1, b2):
    b0_2, b1_2, b2_2 = b0 * b0, b1 * b1, b2 * b2
    return (
        b0 * b0_2,
        b1 * b1_2,
        b2 * b2_2,
        3.0 * b1 * b0_2,
        3.0 * b0 * b1_2,
        3.0 * b2 * b1_2,
        3.0 * b1 * b2_2,
        3.0 * b0 * b2_2,
        3.0 * b2 * b0_2,
        6.0 * b0 * b1 * b2,
    )


def interpolate(control_points, bary):
    """Evaluate the cubic surface point. cp [...,10,3], bary [...,3] -> [...,3]."""
    w = _bernstein(bary[..., 0], bary[..., 1], bary[..., 2])
    out = w[0][..., None] * control_points[..., 0, :]
    for k in range(1, 10):
        out = out + w[k][..., None] * control_points[..., k, :]
    return out


def interpolate_linear(control_points, bary):
    """Barycentric mix of the 3 corner control points (300, 030, 003)
    (reference/bezierTriangle.cpp:99-103).  cp [...,10,3], bary [...,3]."""
    out = bary[..., 0:1] * control_points[..., 0, :]
    for k in (1, 2):
        out = out + bary[..., k:k + 1] * control_points[..., k, :]
    return out

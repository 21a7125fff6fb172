"""BezierPatches struct-of-tensors + batched evaluation.

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

from .. import geom

# control-point index scheme (reference/bezierTriangle.h:42-51)
CP300, CP030, CP003 = 0, 1, 2
CP210, CP120 = 3, 4
CP021, CP012 = 5, 6
CP102, CP201 = 7, 8
CP111 = 9

# first directional-derivative direction: parallel to the side 003->300
# (reference/bezierTriangle.cpp:83)
DERIV_A = (1.0, 0.0, -1.0)


@dataclasses.dataclass(frozen=True)
class BezierPatches:
    control_points: torch.Tensor  # [P, 10, 3] f32
    neighbours: torch.Tensor      # [P, 3] i32
    underlying: torch.Tensor      # [P, 4] f32
    dividers: torch.Tensor        # [P, 3, 4] f32
    bary_inverse: torch.Tensor    # [P, 3, 3] f32
    heights: torch.Tensor         # [P, 2] f32 (inside, outside)
    deriv_b: torch.Tensor         # [P, 3] f32

    @property
    def num_patches(self) -> int:
        return self.control_points.shape[0]

    @property
    def device(self) -> torch.device:
        return self.control_points.device

    def leaves(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def replace(self, **changes) -> "BezierPatches":
        return dataclasses.replace(self, **changes)

    def map(self, fn) -> "BezierPatches":
        """Apply fn to every leaf (e.g. ``lambda t: t.to(device)``)."""
        return BezierPatches(**{k: fn(v) for k, v in self.leaves().items()})

    def detach(self) -> "BezierPatches":
        return self.map(torch.Tensor.detach)

    def row(self, idx) -> "BezierPatches":
        """Gather per-patch rows: every leaf indexed by `idx`, an integer
        tensor of any shape (leading shape idx.shape)."""
        return self.map(lambda leaf: leaf[idx])

    def packed_f32(self) -> torch.Tensor:
        """All float leaves flattened into one row-major [P, 60] table.

        One gather on this table replaces six per-leaf gathers (and, under
        autograd, six backward scatter-adds with one).  Column layout is
        consumed by `from_packed_f32`.
        """
        P = self.num_patches
        return torch.cat(
            [
                self.control_points.reshape(P, 30),
                self.underlying,
                self.bary_inverse.reshape(P, 9),
                self.heights,
                self.deriv_b,
                self.dividers.reshape(P, 12),
            ],
            dim=-1,
        )

    @staticmethod
    def from_packed_f32(table: torch.Tensor, neighbours: torch.Tensor
                        ) -> "BezierPatches":
        """Inverse of `packed_f32` (plus the integer neighbours leaf).

        table [..., 60]; neighbours [..., 3] i32 (pass zeros when the
        consumer does not read them, e.g. the winner recompute)."""
        lead = tuple(table.shape[:-1])
        return BezierPatches(
            control_points=table[..., 0:30].reshape(lead + (10, 3)),
            neighbours=neighbours,
            underlying=table[..., 30:34],
            dividers=table[..., 48:60].reshape(lead + (3, 4)),
            bary_inverse=table[..., 34:43].reshape(lead + (3, 3)),
            heights=table[..., 43:45],
            deriv_b=table[..., 45:48],
        )


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


def bernstein_weights(bary):
    """Cubic Bernstein weights in control-point index order: bary [..., 3] ->
    [..., 10] (reference/bezierTriangle.cpp:105-121)."""
    return torch.stack(_bernstein(bary[..., 0], bary[..., 1], bary[..., 2]), dim=-1)


def interpolate(control_points, bary, acc_dtype=None):
    """Evaluate the cubic surface point. cp [...,10,3], bary [...,3] -> [...,3].

    acc_dtype (the winner search's bf16 mode, config.bf16_sweep): the f32
    weights and the control points are rounded to it, every product and
    sum is taken in it, and the point comes back in f32."""
    w = _bernstein(bary[..., 0], bary[..., 1], bary[..., 2])
    if acc_dtype is not None:
        w = [wk.to(acc_dtype) for wk in w]
        control_points = control_points.to(acc_dtype)
    out = w[0][..., None] * control_points[..., 0, :]
    for k in range(1, 10):
        out = out + w[k][..., None] * control_points[..., k, :]
    return out if acc_dtype is None else out.to(bary.dtype)


def interpolate_linear(control_points, bary):
    """Barycentric mix of the 3 corner control points (300, 030, 003)
    (reference/bezierTriangle.cpp:99-103).  cp [...,10,3], bary [...,3]."""
    out = bary[..., 0:1] * control_points[..., 0, :]
    for k in (1, 2):
        out = out + bary[..., k:k + 1] * control_points[..., k, :]
    return out


def patch_normal(control_points, deriv_b, bary, acc_dtype=None):
    """Unit surface normal via two directional derivatives
    (reference/bezierTriangle.cpp:197-233).

    control_points [...,10,3], deriv_b [...,3], bary [...,3] -> [...,3].
    The three quadratic components sum only their nonzero terms, in the
    control-point order of the reference's weight vectors.  acc_dtype (the
    bf16 mode, as in `interpolate`): the six f32 weights and the control
    points are rounded to it, the components summed in it and brought back
    to f32.
    """
    b0, b1, b2 = bary[..., 0:1], bary[..., 1:2], bary[..., 2:3]
    b0_2, b1_2, b2_2 = b0 * b0, b1 * b1, b2 * b2
    ab = 2.0 * b0 * b1
    bc = 2.0 * b1 * b2
    ac = 2.0 * b0 * b2
    cp = control_points
    if acc_dtype is not None:
        b0_2, b1_2, b2_2, ab, bc, ac = (x.to(acc_dtype) for x in (b0_2, b1_2, b2_2, ab, bc, ac))
        cp = cp.to(acc_dtype)

    def c(k):
        return cp[..., k, :]

    comp0 = b0_2 * c(0) + ab * c(3) + b1_2 * c(4) + b2_2 * c(7) + ac * c(8) + bc * c(9)
    comp1 = b1_2 * c(1) + b0_2 * c(3) + ab * c(4) + bc * c(5) + b2_2 * c(6) + ac * c(9)
    comp2 = b2_2 * c(2) + b1_2 * c(5) + bc * c(6) + ac * c(7) + b0_2 * c(8) + ab * c(9)
    if acc_dtype is not None:
        comp0, comp1, comp2 = (x.to(bary.dtype) for x in (comp0, comp1, comp2))
    comp_a = comp0 - comp2  # dot with DERIV_A = (1, 0, -1)
    comp_b = (deriv_b[..., 0:1] * comp0 + deriv_b[..., 1:2] * comp1
              + deriv_b[..., 2:3] * comp2)
    return geom.safe_normalize(geom.cross(comp_a, comp_b))

"""Geometry kit: batched torch functions over [..., 3] coordinate tensors.

Counterpart of cbtr_tpu/geom.py (the reference's 3dGeomUtil.h, redesigned
as array code).  Conventions are the same:

* ``tri``    : [..., 3, 3]  -- (corner, xyz)
* ``plane``  : [..., 4]     -- ``plane[..., :3]`` unit normal, ``plane[..., 3]``
  constant; points p on the plane satisfy ``dot(p, n) == c``
* rays are separate ``origin`` / ``direction`` tensors ([..., 3])

Three-component sums are written out left to right (``x0 + x1 + x2``) rather
than reduced with ``torch.sum``: the CUDA sweep kernel evaluates the same
expressions in the same order, which keeps the kernel and its plain twin
bit-identical on the card.

The two host-side lattice helpers at the bottom are NumPy.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import DEFAULT as CFG

# ---------------------------------------------------------------------------
# small numeric helpers
# ---------------------------------------------------------------------------


def safe_div(num, den, eps: float = 1e-12):
    """num/den with a sign-preserving clamp on |den| to avoid inf/NaN.

    eps must stay well above sqrt(f32 denormal): the division's backward
    computes num/den^2, and den^2 underflowing to 0 turns masked-lane
    cotangents into 0*inf = NaN that pollutes real gradients.
    """
    den_safe = torch.where(den.abs() < eps, torch.where(den < 0, -eps, eps), den)
    return num / den_safe


def safe_normalize(v, eps: float = 1e-30):
    """v / |v| that returns 0 for (near-)zero vectors instead of NaN."""
    n2 = dot(v, v)[..., None]
    inv = torch.where(n2 < eps, 0.0, 1.0 / torch.sqrt(n2.clamp_min(eps)))
    return v * inv


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def norm(v):
    return torch.sqrt(dot(v, v))


# ---------------------------------------------------------------------------
# util:: equivalents (3dGeomUtil.h:31-165)
# ---------------------------------------------------------------------------


def triangle_normal(tri):
    """(v1-v0) x (v2-v0), unnormalized (3dGeomUtil.h:33-40)."""
    return cross(tri[..., 1, :] - tri[..., 0, :], tri[..., 2, :] - tri[..., 0, :])


def vertex_normal(v0, v1, v2):
    return cross(v1 - v0, v2 - v0)


def inv3x3(m):
    """Closed-form adjugate inverse of [..., 3, 3] (solve3x3.cpp lesson)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = torch.stack(
        [
            torch.stack([co_a, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([co_b, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([co_c, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj * safe_div(torch.ones_like(det), det)[..., None, None]


def barycentric_inverse(v0, v1, v2):
    """Matrix M with b = M @ p for p in the triangle's plane.

    The forward matrix has the vertices as *columns* (3dGeomUtil.h:70-77).
    """
    return inv3x3(torch.stack([v0, v1, v2], dim=-1))


def apply_mat3(m, v):
    """[...,3,3] @ [...,3] -> [...,3], each row a left-to-right sum."""
    return torch.stack([dot(m[..., k, :], v) for k in range(3)], dim=-1)


def a_perpendicular(v):
    """Some unit vector perpendicular to v (3dGeomUtil.h:80-95)."""
    eps = CFG.a_perpendicular_epsilon
    y, z = v[..., 1], v[..., 2]
    degen = (y.abs() < eps) & (z.abs() < eps)
    denom = torch.sqrt(y * y + z * z)
    out_y = torch.where(degen, 1.0, safe_div(-z, denom))
    out_z = torch.where(degen, 0.0, safe_div(y, denom))
    return torch.stack([torch.zeros_like(out_y), out_y, out_z], dim=-1)


# ---------------------------------------------------------------------------
# Plane (3dGeomUtil.h:209-334); packed [..., 4] = (unit normal, constant)
# ---------------------------------------------------------------------------


def make_plane(normal, constant):
    return torch.cat([normal, constant[..., None]], dim=-1)


def plane_normal(plane):
    return plane[..., :3]


def plane_constant(plane):
    return plane[..., 3]


def plane_from_proportion_2points(proportion, p0, p1):
    """Plane perpendicular to p0->p1 at the given proportion
    (3dGeomUtil.h:233-238)."""
    n = safe_normalize(p1 - p0)
    c = dot(n, p1 * proportion + p0 * (1.0 - proportion))
    return make_plane(n, c)


def plane_from_3points(p0, p1, p2):
    """(3dGeomUtil.h:241-246)."""
    n = safe_normalize(cross(p1 - p0, p2 - p0))
    return make_plane(n, dot(n, p0))


def plane_from_1vector_2points(direction, p0, p1):
    """(3dGeomUtil.h:252-257)."""
    n = safe_normalize(cross(direction, p1 - p0))
    return make_plane(n, dot(n, p0))


def intersect_3planes(plane0, plane1, plane2):
    """Common point of three planes via adjugate inverse
    (3dGeomUtil.h:268-276)."""
    m = torch.stack(
        [plane_normal(plane0), plane_normal(plane1), plane_normal(plane2)], dim=-2
    )
    v = torch.stack(
        [plane_constant(plane0), plane_constant(plane1), plane_constant(plane2)],
        dim=-1,
    )
    return apply_mat3(inv3x3(m), v)


def plane_ray_intersect(plane, start, direction):
    """Ray-plane intersection (3dGeomUtil.h:279-299).

    Returns (valid, point, cos_incidence, distance); valid requires
    |cos| >= epsilon AND distance > 0; point is computed unconditionally.
    """
    n = plane_normal(plane)
    cos_incidence = dot(direction, n)
    distance = safe_div(plane_constant(plane) - dot(n, start), cos_incidence)
    valid = (cos_incidence.abs() >= CFG.ray_plane_intersection_epsilon) & (
        distance > 0.0
    )
    point = start + distance[..., None] * direction
    return valid, point, cos_incidence, distance


def plane_distance(plane, point):
    """Signed distance, >0 on the normal side (3dGeomUtil.h:307)."""
    return dot(point, plane_normal(plane)) - plane_constant(plane)


def plane_make_distance_positive(plane, point):
    """Flip the plane so `point` lies on the positive side
    (3dGeomUtil.h:310-317)."""
    flip = plane_distance(plane, point) < 0.0
    return torch.where(flip[..., None], -plane, plane)


# ---------------------------------------------------------------------------
# Uniform triangle subdivision (3dGeomUtil.h:98-122) -- host-side lattice
# ---------------------------------------------------------------------------


def subdivision_barycentrics(divisor: int) -> np.ndarray:
    """All sub-triangle corners of the uniform lattice subdivision.

    Returns [T, 3, 3] barycentric coordinates (T = divisor**2 triangles,
    3 corners, 3 barycentric components), equivalent to util::divide applied
    to the unit barycentric triangle: up-triangles {q, q+e01, q+e02} for
    a+b<=d-1 and down-triangles {q+e01, q+e01+e02, q+e02} for a+b<=d-2.
    """
    d = int(divisor)
    b0 = np.array([1.0, 0.0, 0.0], dtype=np.float32)
    e01 = (np.array([0.0, 1.0, 0.0], dtype=np.float32) - b0) / d
    e02 = (np.array([0.0, 0.0, 1.0], dtype=np.float32) - b0) / d
    tris = []
    for a in range(d):
        for b in range(d - a):
            q = b0 + a * e01 + b * e02
            tris.append([q, q + e01, q + e02])
            if a + b <= d - 2:
                tris.append([q + e01, q + e01 + e02, q + e02])
    return np.asarray(tris, dtype=np.float32)


def subdivision_lattice(divisor: int) -> np.ndarray:
    """Unique barycentric lattice points (i+j+k = divisor)/divisor, [(d+1)(d+2)/2, 3]."""
    d = int(divisor)
    pts = []
    for i in range(d + 1):
        for j in range(d + 1 - i):
            k = d - i - j
            pts.append((i / d, j / d, k / d))
    return np.asarray(pts, dtype=np.float32)

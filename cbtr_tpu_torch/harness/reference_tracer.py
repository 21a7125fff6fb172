"""Pure-NumPy single-ray reference tracer.

Counterpart of cbtr_tpu/harness/reference_tracer.py, carried over so that
the port never imports `cbtr_tpu` (whose package init pulls in jax).  An
independent, line-by-line reimplementation of the reference's
intersection and refraction semantics (reference/bezierTriangle.cpp:123-195,
bezierMesh.cpp:206-227, bezierLens.cpp:4-34) in float64 with scalar control
flow, used as

* the CPU baseline `cbtr_tpu_torch.bench` times `vs_baseline` against, and
* an oracle that shares no code with the port's tensor path.

It reads the port's `BezierPatches` (tensors on any device) as float64
NumPy arrays, and gives the JAX package's tracer's outputs on the same rays
(tests/test_torch_reference_tracer.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT as CFG

W_FOLLOW0, W_FOLLOW1, W_FOLLOW2, W_NONE, W_INTERSECT = 0, 1, 2, 3, 4
R_NONE, R_INSIDE, R_OUTSIDE = 0, 1, 2

# Bernstein exponent table in control-point index order (300..111)
_POWS = np.array(
    [
        [3, 0, 0], [0, 3, 0], [0, 0, 3],
        [2, 1, 0], [1, 2, 0], [0, 2, 1], [0, 1, 2], [1, 0, 2], [2, 0, 1],
        [1, 1, 1],
    ],
    dtype=np.int64,
)
_COEF = np.array([1, 1, 1, 3, 3, 3, 3, 3, 3, 6], dtype=np.float64)


def _numpy(x, dtype=np.float64):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _interp(cp, b):
    w = _COEF * np.prod(np.power(b[None, :], _POWS), axis=1)
    return w @ cp


def _normal(cp, deriv_b, b):
    b0, b1, b2 = b
    c0 = (
        cp[0] * b0 * b0 + cp[7] * b2 * b2 + cp[4] * b1 * b1
        + 2.0 * (cp[8] * b0 * b2 + cp[3] * b0 * b1 + cp[9] * b2 * b1)
    )
    c1 = (
        cp[1] * b1 * b1 + cp[6] * b2 * b2 + cp[3] * b0 * b0
        + 2.0 * (cp[9] * b0 * b2 + cp[4] * b0 * b1 + cp[5] * b1 * b2)
    )
    c2 = (
        cp[2] * b2 * b2 + cp[8] * b0 * b0 + cp[5] * b1 * b1
        + 2.0 * (cp[7] * b0 * b2 + cp[6] * b1 * b2 + cp[9] * b0 * b1)
    )
    ca = c0 - c2  # direction A = (1, 0, -1)
    cb = deriv_b[0] * c0 + deriv_b[1] * c1 + deriv_b[2] * c2
    n = np.cross(ca, cb)
    ln = np.linalg.norm(n)
    return n / ln if ln > 0 else n


class ReferenceTracer:
    """Scalar tracer over a float64 NumPy snapshot of a BezierPatches."""

    def __init__(self, patches):
        self.cp = _numpy(patches.control_points)
        self.neighbours = _numpy(patches.neighbours, np.int64)
        self.underlying = _numpy(patches.underlying)
        self.dividers = _numpy(patches.dividers)
        self.bary_inv = _numpy(patches.bary_inverse)
        self.heights = _numpy(patches.heights)
        self.deriv_b = _numpy(patches.deriv_b)

    # -- single patch (reference/bezierTriangle.cpp:123-195) ----------------
    def intersect_patch(self, i, start, direction, limit_domain):
        n, c = self.underlying[i, :3], self.underlying[i, 3]
        cos_inc = direction @ n
        if abs(cos_inc) < CFG.ray_plane_intersection_epsilon:
            return None
        dist0 = (c - n @ start) / cos_inc
        if dist0 <= 0.0:
            return None
        h_in, h_out = self.heights[i]
        if not (abs(dist0) > -h_in and abs(dist0) > h_out):
            return None
        point0 = start + dist0 * direction
        bary0 = self.bary_inv[i] @ point0
        if limit_domain and not ((bary0 >= 0.0).all() and (bary0 <= 1.0).all()):
            return None

        d_in, d_out = h_in / cos_inc, h_out / cos_inc
        closer = dist0 + (d_in if cos_inc > 0 else d_out)
        further = dist0 + (d_out if cos_inc > 0 else d_in)

        def surf_diff(t):
            p = start + t * direction
            proj = p - n * (p @ n - c)
            b = self.bary_inv[i] @ proj
            return abs(p @ n - c) - abs(_interp(self.cp[i], b) @ n - c)

        diff_c, diff_f = surf_diff(closer), surf_diff(further)
        denom = diff_c - diff_f
        if abs(denom) < CFG.intersection_estimation_epsilon:
            middle = (closer + further) / 2.0
        else:
            middle = (diff_c * further - diff_f * closer) / denom
        if CFG.clamp_secant_estimate:
            lo, hi = min(closer, further), max(closer, further)
            middle = min(max(middle, lo), hi)

        proj_dir = n.copy()
        distance = middle
        for _ in range(CFG.root_search_iterations):
            distance = middle
            p = start + middle * direction
            dd = proj_dir @ n
            t = (c - n @ p) / dd if abs(dd) > 1e-12 else 0.0
            plane_pt = p + t * proj_dir
            bary = self.bary_inv[i] @ plane_pt
            normal = _normal(self.cp[i], self.deriv_b[i], bary)
            surf_pt = _interp(self.cp[i], bary)
            step = surf_pt - plane_pt
            ln = np.linalg.norm(step)
            if ln > 0:
                proj_dir = step / ln
            dn = direction @ normal
            middle = ((surf_pt - start) @ normal) / dn if abs(dn) > 1e-12 else middle

        rel = surf_pt - start
        ray_dist = np.linalg.norm(rel - (rel @ direction) * direction)
        if ray_dist > CFG.max_intersection_distance_from_ray or distance < (
            further - closer
        ) * CFG.minimal_ray_distance:
            return None

        d_div = self.dividers[i, :, :3] @ surf_pt - self.dividers[i, :, 3]
        outside = (1 if d_div[0] < 0 else 0) | (2 if d_div[1] < 0 else 0) | (
            4 if d_div[2] < 0 else 0
        )
        what = {1: W_FOLLOW0, 2: W_FOLLOW1, 4: W_FOLLOW2}.get(outside, W_INTERSECT)
        return dict(
            what=what,
            distance=distance,
            point=surf_pt,
            normal=normal,
            bary=bary,
            cos_incidence=direction @ normal,
            patch=i,
        )

    # -- whole mesh (reference/bezierMesh.cpp:206-227) -----------------------
    def intersect(self, start, direction):
        start = np.asarray(start, np.float64)
        direction = np.asarray(direction, np.float64)
        best = None
        for i in range(self.cp.shape[0]):
            cand = self.intersect_patch(i, start, direction, True)
            if cand is not None and cand["what"] in (W_FOLLOW0, W_FOLLOW1, W_FOLLOW2):
                nb = int(self.neighbours[i, cand["what"]])
                cand = self.intersect_patch(nb, start, direction, False)
            if (
                cand is not None
                and cand["what"] == W_INTERSECT
                and (best is None or cand["distance"] < best["distance"])
            ):
                best = cand
        return best

    # -- refraction (reference/bezierLens.cpp:4-34) ---------------------------
    def refract(self, start, direction, refractive_index, expected):
        hit = self.intersect(start, direction)
        if hit is None or hit["what"] != W_INTERSECT:
            return start, direction, R_NONE
        cos_inc = hit["cos_incidence"]
        status = R_INSIDE if cos_inc < 0.0 else R_OUTSIDE
        eff = 1.0 / refractive_index if status == R_INSIDE else refractive_index
        sin2 = eff * eff * (1.0 - cos_inc * cos_inc)
        if sin2 >= CFG.max_sin2_refraction:
            return start, direction, R_NONE
        if sin2 > CFG.min_sin2_refraction:
            normal = hit["normal"] * (1.0 if status == R_INSIDE else -1.0)
            cos1 = abs(cos_inc)
            cos2 = np.sqrt(1.0 - sin2)
            d = direction * eff + normal * (eff * cos1 - cos2)
            d = d / np.linalg.norm(d)
        else:
            d = direction
        if status != expected:
            return start, direction, R_NONE
        return hit["point"], d, status

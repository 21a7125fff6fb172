"""Pure-NumPy single-ray reference tracer.

Counterpart of cbtr_tpu/harness/reference_tracer.py, carried over so that
the port never imports `cbtr_tpu` (whose package init pulls in jax).  An
independent, line-by-line reimplementation of the reference's
intersection and refraction semantics (reference/bezierTriangle.cpp:123-195,
bezierMesh.cpp:206-227, bezierLens.cpp:4-34) in float64 with scalar control
flow, used as

* the CPU baseline `cbtr_tpu_torch.bench` times `vs_baseline` against, and
* an oracle that shares no code with the port's tensor path
  (`FastReferenceTracer`, the same arithmetic with the patch loop
  vectorized, carries the image-level parity check).

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


class FastReferenceTracer(ReferenceTracer):
    """Patch-vectorized variant of the oracle (NumPy f64, masks instead of
    the per-patch early-outs; still a Python loop over rays with real
    branches for the retry/refraction control flow).

    Exists because image-level parity (BASELINE config 1: 128x128 = 16384
    rays through two refractions) needs ~50k oracle intersections, and the
    scalar loop is far slower.  `tests/test_torch_image_parity.py` holds
    this class against the scalar `ReferenceTracer` on a ray sample, so the
    scalar tracer remains the ground truth.
    """

    def _candidates_all(self, start, direction, limit_domain):
        """(what [P], dist [P]) for one ray against every patch — the same
        arithmetic as ReferenceTracer.intersect_patch with masks."""
        P = self.cp.shape[0]
        n = self.underlying[:, :3]          # [P,3]
        c = self.underlying[:, 3]           # [P]
        cos_inc = n @ direction
        dead = np.abs(cos_inc) < CFG.ray_plane_intersection_epsilon
        cos_safe = np.where(dead, 1.0, cos_inc)
        dist0 = (c - n @ start) / cos_safe
        h_in, h_out = self.heights[:, 0], self.heights[:, 1]
        valid = (~dead) & (dist0 > 0.0)
        valid &= (np.abs(dist0) > -h_in) & (np.abs(dist0) > h_out)

        point0 = start[None, :] + dist0[:, None] * direction[None, :]
        bary0 = np.einsum("pij,pj->pi", self.bary_inv, point0)
        if limit_domain:
            valid &= ((bary0 >= 0.0) & (bary0 <= 1.0)).all(axis=1)

        d_in, d_out = h_in / cos_safe, h_out / cos_safe
        going = cos_inc > 0
        closer = dist0 + np.where(going, d_in, d_out)
        further = dist0 + np.where(going, d_out, d_in)

        def surf_diff(t):
            p = start[None, :] + t[:, None] * direction[None, :]
            pd = np.einsum("pi,pi->p", p, n) - c
            proj = p - n * pd[:, None]
            b = np.einsum("pij,pj->pi", self.bary_inv, proj)
            w = _COEF[None, :] * np.prod(
                np.power(b[:, None, :], _POWS[None, :, :]), axis=2
            )
            surf = np.einsum("pk,pki->pi", w, self.cp)
            sd = np.einsum("pi,pi->p", surf, n) - c
            return np.abs(pd) - np.abs(sd)

        diff_c, diff_f = surf_diff(closer), surf_diff(further)
        denom = diff_c - diff_f
        small = np.abs(denom) < CFG.intersection_estimation_epsilon
        denom_safe = np.where(small, 1.0, denom)
        middle = np.where(
            small,
            (closer + further) / 2.0,
            (diff_c * further - diff_f * closer) / denom_safe,
        )
        if CFG.clamp_secant_estimate:
            middle = np.clip(
                middle, np.minimum(closer, further), np.maximum(closer, further)
            )

        proj_dir = n.copy()
        distance = middle
        surf_pt = np.zeros((P, 3))
        normal = np.zeros((P, 3))
        for _ in range(CFG.root_search_iterations):
            distance = middle
            p = start[None, :] + middle[:, None] * direction[None, :]
            dd = np.einsum("pi,pi->p", proj_dir, n)
            t = np.where(
                np.abs(dd) > 1e-12, (c - np.einsum("pi,pi->p", p, n)) /
                np.where(np.abs(dd) > 1e-12, dd, 1.0), 0.0
            )
            plane_pt = p + t[:, None] * proj_dir
            bary = np.einsum("pij,pj->pi", self.bary_inv, plane_pt)
            # quadratic normal (vectorized _normal)
            b0, b1, b2 = bary[:, 0], bary[:, 1], bary[:, 2]
            cp = self.cp
            c0 = (cp[:, 0] * (b0 * b0)[:, None] + cp[:, 7] * (b2 * b2)[:, None]
                  + cp[:, 4] * (b1 * b1)[:, None]
                  + 2.0 * (cp[:, 8] * (b0 * b2)[:, None]
                           + cp[:, 3] * (b0 * b1)[:, None]
                           + cp[:, 9] * (b2 * b1)[:, None]))
            c1 = (cp[:, 1] * (b1 * b1)[:, None] + cp[:, 6] * (b2 * b2)[:, None]
                  + cp[:, 3] * (b0 * b0)[:, None]
                  + 2.0 * (cp[:, 9] * (b0 * b2)[:, None]
                           + cp[:, 4] * (b0 * b1)[:, None]
                           + cp[:, 5] * (b1 * b2)[:, None]))
            c2 = (cp[:, 2] * (b2 * b2)[:, None] + cp[:, 8] * (b0 * b0)[:, None]
                  + cp[:, 5] * (b1 * b1)[:, None]
                  + 2.0 * (cp[:, 7] * (b0 * b2)[:, None]
                           + cp[:, 6] * (b1 * b2)[:, None]
                           + cp[:, 9] * (b0 * b1)[:, None]))
            ca = c0 - c2
            cb = (self.deriv_b[:, 0:1] * c0 + self.deriv_b[:, 1:2] * c1
                  + self.deriv_b[:, 2:3] * c2)
            nrm = np.cross(ca, cb)
            ln = np.linalg.norm(nrm, axis=1)
            normal = nrm / np.where(ln > 0, ln, 1.0)[:, None]
            w = _COEF[None, :] * np.prod(
                np.power(bary[:, None, :], _POWS[None, :, :]), axis=2
            )
            surf_pt = np.einsum("pk,pki->pi", w, self.cp)
            step = surf_pt - plane_pt
            ln = np.linalg.norm(step, axis=1)
            moved = ln > 0
            proj_dir = np.where(
                moved[:, None], step / np.where(moved, ln, 1.0)[:, None],
                proj_dir,
            )
            dn = normal @ direction
            middle = np.where(
                np.abs(dn) > 1e-12,
                np.einsum("pi,pi->p", surf_pt - start[None, :], normal)
                / np.where(np.abs(dn) > 1e-12, dn, 1.0),
                middle,
            )

        rel = surf_pt - start[None, :]
        along = rel @ direction
        ray_dist = np.linalg.norm(rel - along[:, None] * direction[None, :], axis=1)
        valid &= ray_dist <= CFG.max_intersection_distance_from_ray
        valid &= distance >= (further - closer) * CFG.minimal_ray_distance

        d_div = (np.einsum("pki,pi->pk", self.dividers[:, :, :3], surf_pt)
                 - self.dividers[:, :, 3])
        outside = ((d_div[:, 0] < 0).astype(int) + 2 * (d_div[:, 1] < 0)
                   + 4 * (d_div[:, 2] < 0))
        # {1,2,4} -> follow side; everything else -> cIntersect
        # (ReferenceTracer.intersect_patch's dict .get default)
        what = np.full(P, W_INTERSECT, np.int64)
        what[outside == 1] = W_FOLLOW0
        what[outside == 2] = W_FOLLOW1
        what[outside == 4] = W_FOLLOW2
        what = np.where(valid, what, W_NONE)
        return what, distance

    def intersect(self, start, direction):
        """Same two-pass semantics as ReferenceTracer.intersect, with the
        pass-1 sweep vectorized; retries and the winner's full fields come
        from the scalar path (few per ray)."""
        start = np.asarray(start, np.float64)
        direction = np.asarray(direction, np.float64)
        what, dist = self._candidates_all(start, direction, True)
        best = None
        # direct winners: scalar-confirm each sweep candidate (few per ray)
        for i in np.flatnonzero(what == W_INTERSECT):
            cand = self.intersect_patch(int(i), start, direction, True)
            if (cand is not None and cand["what"] == W_INTERSECT
                    and (best is None or cand["distance"] < best["distance"])):
                best = cand
        # follow-side retries (gate-off re-evaluation of the neighbour)
        for i in np.flatnonzero(what < W_NONE):
            nb = int(self.neighbours[i, what[i]])
            cand = self.intersect_patch(nb, start, direction, False)
            if (cand is not None and cand["what"] == W_INTERSECT
                    and (best is None or cand["distance"] < best["distance"])):
                best = cand
        return best


def oracle_screen_hits(tracer, refractive_index, screen_plane, starts, dirs):
    """The oracle's landing of each ray: entry and exit refraction through
    `tracer` (R_INSIDE, then R_OUTSIDE) and the screen plane, in float64.

    starts/dirs [R,3]; screen_plane [4] (unit normal, constant).  Returns
    (hit2d [R,2] in the screen frame of `render.screen_hits`: u from
    `geom.a_perpendicular` of the normal, v = normal x u; keep [R] bool)."""
    screen = np.asarray(screen_plane, np.float64)
    nrm, c = screen[:3], screen[3]
    y, z = nrm[1], nrm[2]
    if abs(y) < CFG.a_perpendicular_epsilon and abs(z) < CFG.a_perpendicular_epsilon:
        u = np.asarray([0.0, 1.0, 0.0])
    else:
        u = np.asarray([0.0, -z, y]) / np.hypot(y, z)
    v = np.cross(nrm, u)
    starts = np.asarray(starts, np.float64)
    dirs = np.asarray(dirs, np.float64)
    R = len(starts)
    hit2d = np.zeros((R, 2))
    keep = np.zeros(R, bool)
    for i in range(R):
        s1, d1, st1 = tracer.refract(starts[i], dirs[i], refractive_index, R_INSIDE)
        if st1 != R_INSIDE:
            continue
        s2, d2, st2 = tracer.refract(s1, d1, refractive_index, R_OUTSIDE)
        if st2 != R_OUTSIDE:
            continue
        cos = d2 @ nrm
        if abs(cos) < CFG.ray_plane_intersection_epsilon:
            continue
        t = (c - s2 @ nrm) / cos
        if t <= 0:
            continue
        p = s2 + t * d2
        hit2d[i] = [p @ u, p @ v]
        keep[i] = True
    return hit2d, keep


def landing_disagreement(hit2d, keep, hit2d_ref, keep_ref, position_tol: float = 5e-3):
    """Per-ray comparison of two landings (tests/test_image_parity.py's
    measure): (rays kept by one side only, rays kept by both whose positions
    differ by more than position_tol in either screen coordinate, the
    position errors [n_both] of the rays kept by both)."""
    hit2d, hit2d_ref = np.asarray(hit2d, np.float64), np.asarray(hit2d_ref, np.float64)
    keep, keep_ref = np.asarray(keep, bool), np.asarray(keep_ref, bool)
    both = keep & keep_ref
    pos_err = np.abs(hit2d[both] - hit2d_ref[both]).max(axis=-1)
    return int((keep != keep_ref).sum()), int((pos_err > position_tol).sum()), pos_err

"""Frozen copy of `cbtr_tpu_torch/bezier/refine.py` as of the benchmark's first version, for the
plain reference; it imports nothing of the port and is not kept in step with it.

Adaptive thick-patch refinement (splitThickBezierTriangles).

Counterpart of cbtr_tpu/bezier/refine.py, a re-design of
reference/bezierMesh.cpp:79-204: patches whose sampled surface height
exceeds 3% of the original triangle's perimeter are split (all three sides),
single-side splits propagate to edge-sharing neighbours, and each face is
re-emitted as 1/2/3/4 flat triangles whose new vertices blend the cubic
midpoint with the linear midpoint (factor 0.7).

The height/midpoint sampling runs as tensor ops on the patches' device; the
irregular emission (variable triangle counts per face) runs on the host in
NumPy, where the reference keeps it.  The result is a plain triangle mesh
that must be preprocessed and built into patches again (reference
README.md:133).
"""
from __future__ import annotations

import numpy as np
import torch

from . import geom
from .config import DEFAULT as CFG
from .patches import BezierPatches, interpolate, interpolate_linear


def _blended_midpoints(patches: BezierPatches) -> np.ndarray:
    """Split vertex for each patch at barycentric (.5,.5,0):
    0.7*cubic + 0.3*linear (reference/bezierMesh.cpp:200-204).  [P,3]."""
    cp = patches.control_points.detach()
    bary = torch.tensor([0.5, 0.5, 0.0], dtype=cp.dtype, device=cp.device)
    f = CFG.split_bezier_interpolate_factor
    mid = interpolate(cp, bary) * f + interpolate_linear(cp, bary) * (1.0 - f)
    return mid.cpu().numpy().astype(np.float32)


def _face_heights(patches: BezierPatches) -> np.ndarray:
    """Max |height| of each original face's Bezier surface over its flat
    triangle, sampled at the centroid point and at ratios .25/.5/.75 along
    each original side (reference/bezierMesh.cpp:85-96).  [F]."""
    cp = patches.control_points.detach()
    F = cp.shape[0] // 3
    v = cp[:, 0, :].reshape(F, 3, 3)                      # original corners
    plane = geom.plane_from_3points(v[:, 0], v[:, 1], v[:, 2])           # [F,4]
    h = geom.plane_distance(plane, cp.reshape(F, 3, 10, 3)[:, 0, 2, :]).abs()
    ratios = torch.tensor(CFG.sample_ratios_original_side, dtype=cp.dtype,
                          device=cp.device)
    bary = torch.stack([ratios, 1.0 - ratios, torch.zeros_like(ratios)], dim=-1)
    pts = interpolate(cp[:, None, :, :], bary[None, :, :]).reshape(F, 3, -1, 3)
    d = geom.plane_distance(plane[:, None, None, :], pts).abs()         # [F,3,S]
    return torch.maximum(h, d.amax(dim=(1, 2))).cpu().numpy().astype(np.float32)


def split_thick_patches(patches: BezierPatches, fellow, fellow_starts):
    """-> (new_tris [N,3,3] float32, num_split_faces int).

    fellow/fellow_starts are the *original* face neighbour tables the patches
    were built from (the reference keeps them as mOriginalNeighbours)."""
    fellow = np.asarray(fellow)
    fellow_starts = np.asarray(fellow_starts)
    F = fellow.shape[0]
    heights = _face_heights(patches)
    mids = _blended_midpoints(patches).reshape(F, 3, 3)  # per face, per side
    corners = patches.control_points[:, 0, :].detach().cpu().numpy().astype(
        np.float32).reshape(F, 3, 3)
    perim = (
        np.linalg.norm(corners[:, 0] - corners[:, 1], axis=-1)
        + np.linalg.norm(corners[:, 1] - corners[:, 2], axis=-1)
        + np.linalg.norm(corners[:, 2] - corners[:, 0], axis=-1)
    )

    # side-split propagation (reference/bezierMesh.cpp:97-106).  The final
    # state is order-independent (thick faces end at 7 whatever the OR
    # arrival order; 7 | anything == 7), so scatter-OR the neighbour bits,
    # then pin thick faces to 7.
    split_sides = np.zeros(F, np.uint8)
    thick = heights / perim > CFG.bezier_height_per_perimeter_limit
    tf = np.nonzero(thick)[0]
    np.bitwise_or.at(
        split_sides,
        fellow[tf].ravel(),
        (np.uint8(1) << fellow_starts[tf].astype(np.uint8)).ravel(),
    )
    split_sides[tf] = 7

    # emission in the exact face order, through per-face offsets
    # (csSplitCount = popcount+1, reference/bezierMesh.cpp:82)
    pop = np.unpackbits(split_sides[:, None], axis=1).sum(axis=1)
    counts = pop.astype(np.int64) + 1
    offsets = np.concatenate([[0], np.cumsum(counts)])
    out = np.empty((offsets[-1], 3, 3), np.float32)

    o1 = offsets[:-1][counts == 1]
    out[o1] = corners[counts == 1]

    f2 = np.nonzero(counts == 2)[0]
    if f2.size:
        _emit_2split(out, offsets[f2], corners[f2], mids[f2], split_sides[f2])
    f3 = np.nonzero(counts == 3)[0]
    if f3.size:
        _emit_3split(out, offsets[f3], corners[f3], mids[f3], split_sides[f3])
    f4 = np.nonzero(counts == 4)[0]
    if f4.size:
        _emit_4split(out, offsets[f4], corners[f4], mids[f4])
    return out, int(thick.sum())


def _rows(tri, idx):
    """tri [G,3,3], idx [G] -> tri[g, idx[g]] for every g."""
    return tri[np.arange(tri.shape[0]), idx]


def _emit_2split(out, o, tri, mids, split):
    """One side split -> 2 triangles (reference/bezierMesh.cpp:144-152)."""
    i2 = np.array([9, 0, 1, 9, 2], np.int64)[split]  # {1:0, 2:1, 4:2}
    sv = _rows(mids, i2)
    a, b = (i2 + 1) % 3, (i2 + 2) % 3
    out[o] = np.stack([_rows(tri, a), _rows(tri, b), sv], axis=1)
    out[o + 1] = np.stack([_rows(tri, b), _rows(tri, i2), sv], axis=1)


def _emit_3split(out, o, tri, mids, split):
    """Two sides split -> 3 triangles, shorter-diagonal choice per face
    (reference/bezierMesh.cpp:162-178)."""
    i1 = np.array([9, 9, 9, 2, 9, 1, 0], np.int64)[split]  # {3:2, 5:1, 6:0}
    after, before = (i1 + 1) % 3, (i1 + 2) % 3
    t_a, t_b, t_1 = _rows(tri, after), _rows(tri, before), _rows(tri, i1)
    sv_b, sv_a = _rows(mids, before), _rows(mids, after)
    out[o] = np.stack([t_b, sv_b, sv_a], axis=1)
    shorter = (
        np.linalg.norm(t_a - sv_b, axis=-1) < np.linalg.norm(t_1 - sv_a, axis=-1)
    )[:, None, None]
    out[o + 1] = np.where(
        shorter,
        np.stack([t_a, sv_a, sv_b], axis=1),
        np.stack([t_a, sv_a, t_1], axis=1),
    )
    out[o + 2] = np.where(
        shorter,
        np.stack([t_1, t_a, sv_b], axis=1),
        np.stack([t_1, sv_a, sv_b], axis=1),
    )


def _emit_4split(out, o, tri, mids):
    """All sides split -> 4 triangles (reference/bezierMesh.cpp:189-198)."""
    out[o] = mids
    for i in range(3):
        out[o + 1 + i] = np.stack(
            [tri[:, i], mids[:, i], mids[:, (i + 2) % 3]], axis=1
        )

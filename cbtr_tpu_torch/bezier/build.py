"""Vectorized Clough-Tocher Bezier-surface construction.

Counterpart of cbtr_tpu/bezier/build.py.  The reference builds one
BezierTriangle per Clough-Tocher subtriangle through a constructor plus
three bulk-synchronous `setMissingFields*` passes over neighbours
(reference/bezierMesh.cpp:4-51, bezierTriangle.cpp:4-97).  Those passes only
read values of earlier passes, so each is one batched tensor computation
over all P = 3F patches; the construction is differentiable with respect to
the mesh vertices.

Patch layout: original face f -> patches 3f+i, i in 0..2, where patch i spans
(vertex i, vertex i+1, centroid) (reference/bezierMesh.cpp:14-26).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import geom
from ..config import DEFAULT as CFG
from .patches import BezierPatches, interpolate


def build_from_trimesh(mesh, device="cuda", dtype=torch.float32) -> BezierPatches:
    """Convenience: preprocessed TriMesh -> BezierPatches on `device`."""
    arrays = mesh.device_arrays()
    return build_patches(
        torch.as_tensor(arrays["tris"], device=device),
        torch.as_tensor(arrays["fellow_triangles"], device=device),
        torch.as_tensor(arrays["fellow_common_side_starts"], device=device),
        torch.as_tensor(arrays["corner_average_normals"], device=device),
        dtype=dtype,
    )


def build_patches(tris, fellow, fellow_starts, corner_avg_normals,
                  dtype=torch.float32) -> BezierPatches:
    """Build all Bezier patches for a preprocessed mesh.

    tris               [F,3,3] triangle vertices (outward orientation)
    fellow             [F,3] i32: face sharing side (i, i+1)
    fellow_starts      [F,3] i32: side-start index of the shared side inside
                       the fellow face
    corner_avg_normals [F,3,3]: per-corner vertex-average unit normals
    dtype              compute type; the tracer runs on float32 tables,
                       float64 gives a reference build (the three-plane
                       intersections amplify f32 rounding on free-form
                       meshes such as robot.stl)
    """
    tris = tris.to(dtype)
    device = tris.device
    fellow = fellow.to(device=device, dtype=torch.int64)
    fellow_starts = fellow_starts.to(device=device, dtype=torch.int64)
    F = tris.shape[0]
    centroid = tris.mean(dim=1)  # [F,3]

    # per (face, side): v0 = corner i, v1 = corner i+1
    v0 = tris  # [F,3(side),3]
    v1 = torch.roll(tris, -1, dims=1)
    n0 = corner_avg_normals.to(dtype)
    n1 = torch.roll(n0, -1, dims=1)
    cent = centroid[:, None, :].expand_as(v0)

    face_normal_unit = geom.safe_normalize(geom.triangle_normal(tris))  # [F,3]
    fellow_normal_unit = face_normal_unit[fellow]  # [F,3,3]

    # plane between original neighbours: through the shared edge, oriented
    # along the summed face normals (reference/bezierMesh.cpp:20-21)
    plane_between = geom.plane_from_1vector_2points(
        face_normal_unit[:, None, :] + fellow_normal_unit, v0, v1
    )  # [F,3,4]

    # neighbour indices after the split (reference/bezierMesh.cpp:23-25)
    side_idx = torch.arange(3, device=device)
    base = (torch.arange(F, device=device) * 3)[:, None]
    neighbours = torch.stack(
        [
            3 * fellow + fellow_starts,
            (base + (side_idx + 1) % 3).expand(F, 3),
            (base + (side_idx + 2) % 3).expand(F, 3),
        ],
        dim=-1,
    ).to(torch.int32)  # [F,3,3]

    # ---- phase 0: constructor (reference/bezierTriangle.cpp:4-43) ----------
    common_plane_v0 = geom.make_plane(n0, geom.dot(v0, n0))
    common_plane_v1 = geom.make_plane(n1, geom.dot(v1, n1))
    prop_side = CFG.proportion_control_on_original_side
    perp_side0 = geom.plane_from_proportion_2points(prop_side, v0, v1)
    perp_side1 = geom.plane_from_proportion_2points(prop_side, v1, v0)

    cp210 = geom.intersect_3planes(common_plane_v0, plane_between, perp_side0)
    cp120 = geom.intersect_3planes(common_plane_v1, plane_between, perp_side1)

    original_normal = geom.vertex_normal(v0, v1, cent)
    parallel0 = geom.plane_from_1vector_2points(original_normal, v0, cent)
    parallel1 = geom.plane_from_1vector_2points(original_normal, v1, cent)
    prop_vc = CFG.proportion_control_on_original_vertex_centroid
    perp_split0 = geom.plane_from_proportion_2points(prop_vc, v0, cent)
    perp_split1 = geom.plane_from_proportion_2points(prop_vc, v1, cent)

    cp201 = geom.intersect_3planes(common_plane_v0, parallel0, perp_split0)
    cp021 = geom.intersect_3planes(common_plane_v1, parallel1, perp_split1)

    perp_between_via_side_cps = geom.plane_from_1vector_2points(
        geom.plane_normal(plane_between), cp210, cp120
    )
    half_side_cps = geom.plane_from_proportion_2points(0.5, cp210, cp120)
    perp_median = geom.plane_from_proportion_2points(
        CFG.proportion_control_on_original_median, (v0 + v1) / 2.0, cent
    )
    cp111 = geom.intersect_3planes(perp_between_via_side_cps, half_side_cps, perp_median)

    divider0 = geom.plane_make_distance_positive(plane_between, cp111)

    # ---- phase 1: control points flanking the internal split edges ---------
    # (reference/bezierTriangle.cpp:45-60); next/prev are the same-face
    # subtriangles i+1 / i+2
    cp111_next = torch.roll(cp111, -1, dims=1)
    cp111_prev = torch.roll(cp111, 1, dims=1)

    plane_two_middles0 = geom.plane_from_3points(cp201, cp111, cp111_prev)
    plane_two_middles1 = geom.plane_from_3points(cp021, cp111_next, cp111)
    perp_split0_rev = geom.plane_from_proportion_2points(prop_vc, cent, v0)
    perp_split1_rev = geom.plane_from_proportion_2points(prop_vc, cent, v1)

    cp102 = geom.intersect_3planes(plane_two_middles0, parallel0, perp_split0_rev)
    cp012 = geom.intersect_3planes(plane_two_middles1, parallel1, perp_split1_rev)

    # ---- phase 2: centroid point, plane, heights, derivative dirs ----------
    # (reference/bezierTriangle.cpp:62-86)
    cp012_next = torch.roll(cp012, -1, dims=1)
    cp003 = (cp102 + cp012 + cp012_next) / 3.0

    underlying = geom.plane_from_3points(v0, v1, cp003)
    bary_inverse = geom.barycentric_inverse(v0, v1, cp003)

    # stacked in control-point index order CP300..CP111
    control_points = torch.stack(
        [v0, v1, cp003, cp210, cp120, cp021, cp012, cp102, cp201, cp111], dim=-2
    )

    # sample surface height over the underlying plane at the barycentric
    # lattice of the height-sample divisor (reference/bezierTriangle.cpp:71-82)
    lattice = torch.as_tensor(
        np.asarray(geom.subdivision_lattice(CFG.height_sample_divisor)),
        device=device, dtype=dtype,
    )  # [L,3]
    pts = interpolate(control_points[..., None, :, :], lattice[None, None, :, :])
    dist = geom.plane_distance(underlying[..., None, :], pts)  # [F,3,L]
    h_inside = dist.amin(dim=-1).clamp_max(0.0) * CFG.height_safety_factor
    h_outside = dist.amax(dim=-1).clamp_min(0.0) * CFG.height_safety_factor
    heights = torch.stack([h_inside, h_outside], dim=-1)

    plane_n = geom.plane_normal(underlying)
    deriv_b = geom.apply_mat3(bary_inverse, geom.cross(cp003 - v0, plane_n))

    # ---- phase 3: remaining divider planes (reference/bezierTriangle.cpp:88-97)
    n_next = torch.roll(plane_n, -1, dims=1)
    n_prev = torch.roll(plane_n, 1, dims=1)
    divider1 = geom.plane_from_1vector_2points(plane_n + n_next, v1, cp003)
    divider2 = geom.plane_from_1vector_2points(plane_n + n_prev, v0, cp003)
    divider1 = geom.plane_make_distance_positive(divider1, cp111)
    divider2 = geom.plane_make_distance_positive(divider2, cp111)
    dividers = torch.stack([divider0, divider1, divider2], dim=-2)  # [F,3,3,4]

    P = F * 3
    return BezierPatches(
        control_points=control_points.reshape(P, 10, 3),
        neighbours=neighbours.reshape(P, 3),
        underlying=underlying.reshape(P, 4),
        dividers=dividers.reshape(P, 3, 4),
        bary_inverse=bary_inverse.reshape(P, 3, 3),
        heights=heights.reshape(P, 2),
        deriv_b=deriv_b.reshape(P, 3),
    )

"""Frozen copy of `cbtr_tpu_torch/config.py` as of the benchmark's first version, for the
plain reference; it imports nothing of the port and is not kept in step with it.

Central configuration: every tunable constant of the pipeline.

Counterpart of cbtr_tpu/config.py with the same fields and defaults, so the
port reproduces the reference implementation's numerical behaviour:

- general epsilons            -> reference/3dGeomUtil.h:19-20, :219
- vertex welding / normals    -> reference/mesh.h:20-22
- Bezier construction         -> reference/bezierTriangle.h:53-62
- thick-patch refinement      -> reference/bezierMesh.h:12-14
- refraction cutoffs          -> reference/bezierLens.h:16-17

"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Config:
    # --- global geometry epsilons (3dGeomUtil.h:19-20) ---
    general_epsilon: float = 1.0e-5
    ray_plane_intersection_epsilon: float = 1.0e-5  # Plane::csRayPlaneIntersectionEpsilon (3dGeomUtil.h:219)
    a_perpendicular_epsilon: float = 1.0e-10        # util::getAperpendicular (3dGeomUtil.h:81)

    # --- mesh preprocessing (mesh.h:20-22) ---
    standardize_vertices_epsilon_factor: float = 0.2
    standardize_normals_epsilon: float = 0.01
    standardize_normals_independent_move_factor: float = 0.2

    # --- Bezier triangle construction (bezierTriangle.h:53-62) ---
    proportion_control_on_original_side: float = 0.291
    proportion_control_on_original_vertex_centroid: float = 0.304
    proportion_control_on_original_median: float = 0.2
    height_safety_factor: float = 1.33333333
    root_search_iterations: int = 4
    height_sample_divisor: int = 5
    max_intersection_distance_from_ray: float = 0.01
    minimal_ray_distance: float = 1.0
    intersection_estimation_epsilon: float = 1.0e-6

    # Improvement over the reference (not a reference constant): clamp the
    # secant-style first estimate into the [closer, further] bracket.  The
    # reference's unclamped secant (bezierTriangle.cpp:137-152) can
    # extrapolate far outside the bracket on concave geometry and lose real
    # exit hits; clamping recovers them and is a no-op whenever the estimate
    # already lies inside the bracket.  Set False for strict
    # reference-parity semantics.
    #
    # PyTorch runs eagerly, so the flag is read at every call; the CUDA
    # sweep kernel receives it as a runtime argument.
    clamp_secant_estimate: bool = True

    # --- thick-patch refinement (bezierMesh.h:12-14) ---
    sample_ratios_original_side: tuple = (0.25, 0.5, 0.75)
    bezier_height_per_perimeter_limit: float = 0.03
    split_bezier_interpolate_factor: float = 0.7

    # --- refraction (bezierLens.h:16-17) ---
    max_sin2_refraction: float = 0.99
    min_sin2_refraction: float = 1.0e-12


PI = math.pi

DEFAULT = Config()

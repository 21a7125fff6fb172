"""Central configuration: every tunable constant of the pipeline.

Counterpart of cbtr_tpu/config.py with the same fields and defaults, so the
port reproduces the reference implementation's numerical behaviour:

- general epsilons            -> reference/3dGeomUtil.h:19-20, :219
- vertex welding / normals    -> reference/mesh.h:20-22
- Bezier construction         -> reference/bezierTriangle.h:53-62
- thick-patch refinement      -> reference/bezierMesh.h:12-14
- refraction cutoffs          -> reference/bezierLens.h:16-17

`fast_newton` and `bf16_sweep` are the JAX package's opt-in sweep variants,
default off as there; each sweep kernel (K1-K3) and its plain twin take
them, the recompute never does.
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

    # Opt-in fast-math sweep, default OFF (not a reference constant): the
    # winner search's divisions (the plane hit, the two bracket ends, the
    # secant, two a Newton iteration: 12 a pair) become an exponent-negation
    # reciprocal with 2 Newton refinements (`intersect.fast_recip`, relative
    # error under 1e-5; the JAX package's `_fast_recip` bit for bit), where
    # the default build issues IEEE divisions (-prec-div=true).  Acceptance
    # and distances shift by about 1e-5, so a few winners can move; the
    # differentiable recompute stays exact.  Read at every call, as every
    # field here (no trace); the kernels take it as a template mode, and its
    # speed on the card is in PERF.md section 6.
    fast_newton: bool = False

    # Opt-in sub-f32 sweep, default OFF: the Bernstein interpolation's and
    # the normal's polynomial sums of the winner search run in bfloat16
    # (weights and control points rounded to bf16, every product and sum
    # rounded to bf16, the result back in f32); brackets, compares and
    # acceptance stay f32, as in the JAX package.  bf16's 8-bit mantissa is
    # far below the acceptance epsilons, so hits and winners move (a few
    # percent); the recompute stays exact f32.  The kernels round every
    # operation as torch does (<cuda_bf16.h>, one value a lane), so each is
    # bit-equal to its twin on the card; the JAX package agrees with that
    # only where XLA rounds every bf16 operation
    # (--xla_allow_excess_precision=false).
    bf16_sweep: bool = False

    # --- thick-patch refinement (bezierMesh.h:12-14) ---
    sample_ratios_original_side: tuple = (0.25, 0.5, 0.75)
    bezier_height_per_perimeter_limit: float = 0.03
    split_bezier_interpolate_factor: float = 0.7

    # --- refraction (bezierLens.h:16-17) ---
    max_sin2_refraction: float = 0.99
    min_sin2_refraction: float = 1.0e-12


PI = math.pi

DEFAULT = Config()

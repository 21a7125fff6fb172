"""Cubic Bezier-triangle surface layer: the `BezierPatches` struct of tensors,
its batched evaluation, the Clough-Tocher construction, tessellation and the
thick-patch refinement."""
from .patches import (  # noqa: F401
    BezierPatches,
    bernstein_weights,
    interpolate,
    interpolate_linear,
    patch_normal,
)
from .build import build_from_trimesh, build_patches  # noqa: F401
from .tessellate import tessellate, tessellate_to_numpy  # noqa: F401
from .refine import split_thick_patches  # noqa: F401

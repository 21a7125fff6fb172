"""Cubic Bezier-triangle surface layer: the `BezierPatches` struct of tensors,
its batched evaluation and the Clough-Tocher construction."""
from .patches import (  # noqa: F401
    BezierPatches,
    bernstein_weights,
    interpolate,
    patch_normal,
)
from .build import build_from_trimesh, build_patches  # noqa: F401

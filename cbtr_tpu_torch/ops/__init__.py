"""Compute ops: ray-surface intersection (CUDA kernels K1 and K2 on the GPU,
their plain PyTorch twins on the CPU)."""
from .intersect import (  # noqa: F401
    RayHit,
    WHAT_FOLLOW_SIDE0,
    WHAT_FOLLOW_SIDE1,
    WHAT_FOLLOW_SIDE2,
    WHAT_NONE,
    WHAT_INTERSECT,
    intersect_rays,
    patch_candidates,
)


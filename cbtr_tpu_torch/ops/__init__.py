"""Compute ops: ray-surface intersection (CUDA kernel on the GPU, plain
PyTorch twin on the CPU)."""
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

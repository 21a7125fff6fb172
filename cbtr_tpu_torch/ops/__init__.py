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


def launch_counters() -> dict:
    """{kernel: the wrapper whose `launches` counts the kernel's launches}
    for every kernel of this package, from the registries that hold the
    wrappers themselves (so a caller that wraps a module's function still
    finds the counter)."""
    from . import cuda_codes, cuda_emitter, cuda_recompute, cuda_segment, cuda_sweep
    from . import cuda_tables
    from . import cuda_winner  # noqa: F401  (adds K2 to cuda_sweep._counted)

    return {**cuda_sweep._counted, "sweep_codes": cuda_codes.sweep_codes_cuda,
            **cuda_tables._COUNTED, "segment_sum": cuda_segment.segment_sum,
            **cuda_recompute.COUNTED, "emitter": cuda_emitter.launch}

"""Device ms a step of the recompute's forward and backward kernels
(`csrc/recompute.cu`) and of the fixed-order segment sums
(`csrc/segment_sum.cu`), which in a fit step add the recompute's row
gradients (the fit's splat is a matrix product)."""
from portbench.kernels import RECOMPUTE_KERNELS, SEGMENT_SUM_KERNELS


def read(traced):
    ms = traced.kernel_ms(RECOMPUTE_KERNELS + SEGMENT_SUM_KERNELS)
    return ms / traced.units if ms > 0.0 else None

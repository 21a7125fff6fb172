"""Device ms a render of the splat's fixed-order segment sum
(`csrc/segment_sum.cu`: its radix sort, bounds and folds), the 4K splat's
only kernels of that file (a forward render has no recompute backward)."""
from portbench.kernels import SEGMENT_SUM_KERNELS


def read(traced):
    ms = traced.kernel_ms(SEGMENT_SUM_KERNELS)
    return ms / traced.units if ms > 0.0 else None

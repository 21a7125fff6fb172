"""Runtime utilities: checkpoint/resume, profiling, throughput metering, and
the threefry random numbers of the device emitter (`utils.prng`)."""
from .checkpoint import (  # noqa: F401
    load_params,
    load_patches,
    save_params,
    save_patches,
)
from .profiling import RateMeter, trace  # noqa: F401

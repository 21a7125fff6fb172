"""Runtime utilities: checkpoint/resume, profiling (the port's spans and
counters, Chrome traces), and the threefry random numbers of the device
emitter (`utils.prng`)."""
from .checkpoint import (  # noqa: F401
    load_params,
    load_patches,
    save_params,
    save_patches,
)
from .profiling import counting, span, spans_on, timing, trace  # noqa: F401

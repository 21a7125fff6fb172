"""The least time an H100 could take for the ray synthesis of one render:
the roofline that `emitter_roofline` reads the synthesis's device time
against.

The synthesis's output, counted from the reference's definition
(`reference/emitter.py::rays`): each ray's start and direction (three
float32 each) and its weight (one float32), RAY_BYTES a ray, written once,
at the HBM3 rate of NVIDIA's H100 SXM data sheet.  Its inputs are the seed
and the ray's index, and the per-bin tables a kernel could derive from the
belt count, so no input byte is counted.  The hash's integer operations are
not counted: the data sheet gives no int32 rate outside the tensor cores.
"""
from __future__ import annotations

from .sweep import PEAK_BYTES_PER_S

RAY_BYTES = 12 + 12 + 4          # start, direction, weight: float32


def render_bytes(n_rays: int) -> int:
    """The bytes a render's synthesis has to write."""
    return int(n_rays) * RAY_BYTES


def bound_s(n_rays: int) -> float:
    """The least device time of a render's synthesis, in seconds."""
    return render_bytes(n_rays) / PEAK_BYTES_PER_S

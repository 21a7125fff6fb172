"""Optics layer: Snell refraction through Bezier lens surfaces."""
from .lens import (  # noqa: F401
    REFRACT_NONE,
    REFRACT_INSIDE,
    REFRACT_OUTSIDE,
    refract_rays,
    trace_through_lens,
)

"""Host-side harness: the canonical mesh preprocessing sequence, and the
stage profiler of the render and train step (`profile_step`, run as a
module)."""
from .measure import preprocess  # noqa: F401

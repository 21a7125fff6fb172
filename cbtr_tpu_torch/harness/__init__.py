"""Host-side harness: the canonical mesh preprocessing sequence, the
reference's approximation-error benchmark, and the stage profiler of the
render and train step (`profile_step`, run as a module)."""
from .measure import measure_approximation, preprocess  # noqa: F401

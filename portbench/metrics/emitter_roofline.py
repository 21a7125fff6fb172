"""The ray synthesis's share of its roofline, in %: the least time the H100
could take to write a render's rays (`work/emitter.py`: 28 B a ray at the
HBM3 rate) over the synthesis's device ms a render
(`emitter_ms_per_render`).  None where that finds nothing to read."""
from portbench.metrics import emitter_ms_per_render
from portbench.work.emitter import bound_s


def read(traced):
    ms = emitter_ms_per_render.read(traced)
    if not ms:
        return None
    return 100.0 * bound_s(traced.state.n_rays) * 1e3 / ms

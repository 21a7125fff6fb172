"""The counted batch: after the traced window, as many units again with the
program's span timing and pair counters on and the profiler off
(`cbtr_tpu_torch/utils/profiling.py`: `timing()`, `counting()`), run once
a traced run for every reader that needs it (`host_issue_ms_per_step`,
`cull_excess`).

A program without those switches (a checkout older than them) runs no
counted batch, and the readers then find nothing to read.  Where it runs,
the check that follows the traced run follows this batch: the render's
`rerun` holds its last image, the fit cells restart their step object.
"""
from __future__ import annotations

import sys
import time
from typing import Dict, NamedTuple, Optional, Tuple


class Counted(NamedTuple):
    units: int
    seconds: float                          # host time of the batch, end to end
    spans: Dict[str, list]                  # span name -> [total host ns, count]
    pairs: Dict[str, Tuple[int, int]]       # kernel stem -> (pass-1 pairs, retries)


def _program():
    """The program's profiling and K1/K2 modules, or None where they lack the
    switches and the counters."""
    from cbtr_tpu_torch.ops import cuda_sweep
    from cbtr_tpu_torch.utils import profiling

    needed = (hasattr(profiling, "timing") and hasattr(profiling, "counting")
              and hasattr(cuda_sweep, "pair_counts"))
    return (profiling, cuda_sweep) if needed else None


def run(unit, units: int) -> Optional[Counted]:
    """`units` units under timing() and counting(); None where the program
    has neither."""
    program = _program()
    if program is None:
        return None
    profiling, cuda_sweep = program
    cuda_sweep.reset_pair_counts()
    t0 = time.perf_counter()
    with profiling.timing() as spans, profiling.counting():
        for _ in range(units):
            unit()
    seconds = time.perf_counter() - t0
    return Counted(units, seconds, {k: list(v) for k, v in spans.items()},
                   cuda_sweep.pair_counts())


def batch(traced) -> Optional[Counted]:
    """The traced run's counted batch, run at the first call and kept on the
    cell's state; it prints its host time a unit beside the untraced
    units' (the cost of timing and counting)."""
    state = traced.state
    if not hasattr(state, "_counted_batch"):
        counted = run(state.unit, traced.units)
        if counted is not None:
            print(f"portbench: counted batch: {counted.units} units, "
                  f"{counted.seconds / counted.units:.6f} s a unit "
                  f"(untraced {traced.untraced_s / traced.units:.6f})",
                  file=sys.stderr, flush=True)
        state._counted_batch = counted
    return state._counted_batch

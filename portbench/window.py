"""The measured window and the arithmetic of the end-to-end metrics.

A window is a closed loop: the next unit of work (a render, a fit step)
starts when the previous one has completed, until `seconds` have passed.
Every unit is timed on the host clock from its start to its completion (the
image synchronised, the loss read back).  A rate is all the work of all
units over the window's whole time; a tail is the percentile of every unit.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Callable, List, NamedTuple, Tuple


class Window(NamedTuple):
    unit_s: List[float]    # each unit's host time, start to completion
    work: List[int]        # each unit's work (rays)
    ok: List[bool]         # each unit's result was sound (a finite loss)
    seconds: float         # from the first unit's start to the last one's end


def run(unit: Callable[[], Tuple[int, bool]], seconds: float) -> Window:
    """Run `unit` back to back until `seconds` have passed; the unit under
    way when they pass completes and counts.  The objects that set-up left
    are collected and frozen first, so that the collector, which still runs,
    walks only what the window makes."""
    unit_s, work, ok = [], [], []
    gc.collect()
    gc.freeze()
    try:
        start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            w, good = unit()
            t1 = time.perf_counter()
            unit_s.append(t1 - t0)
            work.append(int(w))
            ok.append(bool(good))
            if t1 - start >= seconds:
                return Window(unit_s, work, ok, t1 - start)
    finally:
        gc.unfreeze()


def rate(window: Window) -> float:
    """All work completed in the window over the window's time."""
    return sum(window.work) / window.seconds


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (q in (0, 100]) of every value."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("no values")
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]

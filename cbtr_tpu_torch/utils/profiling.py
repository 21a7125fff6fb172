"""Profiling + throughput observability.

Counterpart of cbtr_tpu/utils/profiling.py:

* `trace(logdir)` -- context manager around `torch.profiler.profile`
  (host and, where there is a card, device activity) that writes a Chrome
  trace into `logdir` (viewable in Perfetto or chrome://tracing);
* `RateMeter` -- a rays/s (or any unit/s) counter with EMA smoothing for
  long-running render/optimization loops.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block; on exit write `logdir/trace_<pid>_<ns>.json`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class RateMeter:
    """Exponential-moving-average throughput meter."""

    def __init__(self, unit: str = "rays", alpha: float = 0.2):
        self.unit = unit
        self.alpha = alpha
        self.rate: Optional[float] = None
        self.total = 0
        self._t_last: Optional[float] = None

    def tick(self, count: int) -> float:
        """Record `count` units processed since the previous tick."""
        now = time.perf_counter()
        if self._t_last is not None:
            dt = max(now - self._t_last, 1e-9)
            inst = count / dt
            self.rate = (
                inst
                if self.rate is None
                else self.alpha * inst + (1.0 - self.alpha) * self.rate
            )
        self._t_last = now
        self.total += count
        return self.rate or 0.0

    def __str__(self) -> str:
        r = self.rate or 0.0
        return f"{r:,.0f} {self.unit}/s (total {self.total:,})"

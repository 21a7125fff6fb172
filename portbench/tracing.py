"""The traced window: spans around the calls into the port's layers, the
profiler's device ops, and the arithmetic the per-layer readers share.

Spans are `torch.profiler.record_function` ranges opened by wrappers that the
benchmark sets on module attributes of the port (each is called through its
module's global, so wrapping the attribute wraps every call on the path), as
the port's `harness/profile_step.py` wraps them with CUDA events.  The busy
time is the union of the device ops' intervals inside the window, as there.
"""
from __future__ import annotations

import contextlib
import importlib
import re
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

import torch

WINDOW_SPAN = "portbench.window"
UNIT_SPAN = "portbench.unit"


@contextlib.contextmanager
def spans(stages):
    """Wrap each (label, module name, attribute) of the port in a
    record_function range named `portbench.<label>` for the block's length."""
    saved = []

    def wrap(label, fn):
        def traced(*args, **kwargs):
            with torch.profiler.record_function(f"portbench.{label}"):
                return fn(*args, **kwargs)
        return traced

    try:
        for label, module_name, attr in stages:
            module = importlib.import_module(module_name)
            saved.append((module, attr, getattr(module, attr)))
            setattr(module, attr, wrap(label, getattr(module, attr)))
        yield
    finally:
        for module, attr, fn in reversed(saved):
            setattr(module, attr, fn)


class Traced(NamedTuple):
    """What a per-layer reader gets: the traced units' device ops and host
    spans (profiler clock, microseconds), the window, and the cell."""

    units: int
    window: Tuple[float, float]
    device_ops: List[Tuple[str, float, float]]   # (kernel name, start, end)
    spans: List[Tuple[str, float, float]]        # (portbench.<label>, start, end)
    state: object                                # the driver's state
    cell: object
    untraced_s: float = 0.0    # host seconds of as many units run untraced just before

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        return busy_us(self.device_ops, self.window) / 1e6

    def kernel_ms(self, names) -> float:
        """Device ms of the ops whose base kernel name is in `names`."""
        names, seen = set(names), {}
        total = 0.0
        for n, a, b in self.device_ops:
            if n not in seen:
                seen[n] = base_name(n) in names
            total += (b - a) if seen[n] else 0.0
        return total / 1e3


def base_name(kernel: str) -> str:
    """A kernel's name without its arguments, template arguments and
    namespaces: `void (anonymous namespace)::k<0, false>(float const*)` ->
    `k`."""
    name, before = kernel.replace("(anonymous namespace)::", "").split("(")[0], None
    while name != before:         # innermost template brackets first
        before, name = name, re.sub(r"<[^<>]*>", "", name)
    words = name.split()
    return words[-1].split("::")[-1] if words else kernel


def _merged(intervals, window):
    lo, hi = window
    out = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_us(device_ops, window) -> float:
    """The union of the device ops' intervals inside the window."""
    return sum(b - a for a, b in _merged([(a, b) for _, a, b in device_ops], window))


def idle_gaps(device_ops, window) -> List[Tuple[float, float]]:
    """The window's stretches in which no device op ran."""
    merged = _merged([(a, b) for _, a, b in device_ops], window)
    edges = [window[0]] + [x for ab in merged for x in ab] + [window[1]]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def _innermost(spans, t) -> str:
    best = None
    for name, a, b in spans:
        if a <= t <= b and (best is None or a >= best[1]):
            best = (name, a)
    return best[0] if best else "outside the benchmark's spans"


def breakdown(traced: Traced, top: int = 10) -> Dict[str, list]:
    """The device ops that took most time ([name, seconds], summed by name)
    and the idle time by the innermost span the host was in at each gap's
    middle ([span, seconds], summed by span), each the `top` largest."""
    ops, names = defaultdict(float), {}
    for name, a, b in traced.device_ops:
        if name not in names:
            names[name] = base_name(name)
        ops[names[name]] += (b - a) / 1e6
    idle = defaultdict(float)
    inner = [s for s in traced.spans if s[0] != WINDOW_SPAN]
    for a, b in idle_gaps(traced.device_ops, traced.window):
        idle[_innermost(inner, (a + b) / 2.0)] += (b - a) / 1e6
    return {
        "device_ops": [[k, v] for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
    }


def is_device_op(event) -> bool:
    """A kernel, copy or fill on the device's timeline.  The profiler mirrors
    record_function ranges onto that timeline too (the harness's spans,
    torch's `Optimizer.step#Adam.step`): those span the gaps between the
    kernels they enclose, and are no device op."""
    return (event.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False))


def profile_units(unit, units: int, stages, state, cell) -> Traced:
    """Run `units` units untraced (timed on the host clock), then as many
    under the profiler (CPU and CUDA activity) inside the stages' spans, each
    in a `portbench.unit` range, all in a `portbench.window` range; returns
    what the readers read."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    for _ in range(units):
        unit()
    untraced_s = time.perf_counter() - t0
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with spans(stages), profile(activities=activities) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            for _ in range(units):
                with torch.profiler.record_function(UNIT_SPAN):
                    unit()
    device, host = [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.name.startswith("portbench."):
            if e.device_type != torch.autograd.DeviceType.CUDA:
                host.append((e.name, a, b))
        elif is_device_op(e):
            device.append((e.name, a, b))
    window = next((a, b) for n, a, b in host if n == WINDOW_SPAN)
    return Traced(units=units, window=window, device_ops=device, spans=host, state=state,
                  cell=cell, untraced_s=untraced_s)

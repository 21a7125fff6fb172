"""Profiling: the port's named spans and counters, and Chrome traces.

Counterpart of cbtr_tpu/utils/profiling.py, and the port's one span and
counter API:

* `span(name)` -- a named span at a layer boundary, as a context manager
  or a decorator.  Spans are off by default: an off span costs one flag
  check and a lookup of its name's shared no-op (the decorator adds its
  call).  `@span(name, device=True)` also times the card: under `timing()`
  it records a CUDA event pair on the current stream where its work is on
  a card, resolved into `<name>.device` when the `timing()` block closes;
* `backward_span(name)` -- a decorator that puts a plain-torch layer's
  backward in a span: while spans or timing are on, a pair of identity
  autograd Functions opens it when the gradient reaches the layer's
  outputs and closes it when the layer's backward nodes have run;
* `spans_on()` -- each span is a `torch.profiler.record_function` range,
  on the profiler's clock with the device ops, so an idle gap of the
  device can be put down to the innermost span the host was in;
* `timing()` -- each span adds its host-clock duration to a per-name
  total and count (`SpanTimes`), on any thread (autograd runs a CUDA
  backward on a thread of its own), and each device-timed span its
  device time between its events under `<name>.device`; no profiler;
* `counting()` -- the winner kernels count the pairs they evaluate into
  device accumulators (`ops.cuda_sweep.pair_counts`);
* `count(name)` -- a counter in `timing()`'s totals (a count, no time):
  the fit step's `cbtr.step.capture`, `.replay` and `.eager`;
* `trace(logdir)` -- `torch.profiler.profile` (host and, where there is
  a card, device activity) with spans on, writing a Chrome trace into
  `logdir` (viewable in Perfetto or chrome://tracing).

Each switch is a context manager that restores the state it found.
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from typing import Dict, Iterator, Optional

import torch

# the switches: spans as profiler ranges, the span totals being kept (or
# None), the kernels' pair counters; _ON is whether a span does anything
_RECORD = False
_TIMES: Optional["SpanTimes"] = None
_COUNTING = False
_ON = False
_LOCK = threading.Lock()


class SpanTimes(dict):
    """name -> [total host ns, count] of the spans closed while `timing()`
    was on, on every thread; `<name>.device` -> [total device ns, count] of
    the device-timed ones, once the block has closed."""

    def __init__(self):
        super().__init__()
        self.pending = []       # (name, start event, end event), unresolved

    def add(self, name: str, ns: int) -> None:
        with _LOCK:
            entry = self.get(name)
            if entry is None:
                self[name] = [ns, 1]
            else:
                entry[0] += ns
                entry[1] += 1

    def add_events(self, name: str, start, end) -> None:
        with _LOCK:
            self.pending.append((name, start, end))

    def resolve(self) -> None:
        """Wait for each pending event pair and add its device time."""
        pending, self.pending = self.pending, []
        for name, start, end in pending:
            end.synchronize()
            self.add(f"{name}.device", round(start.elapsed_time(end) * 1e6))


def _cuda_event(device):
    """A timing event recorded now on `device`'s current stream, or None
    where the device is no card or its stream is being captured into a
    CUDA graph (which records no timing event)."""
    if device is None or device.type != "cuda" or torch.cuda.is_current_stream_capturing():
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


class _Open:
    """What one span holds while it is open: its record_function range and
    the totals and start it adds to, as the switches were when it opened,
    and its start event where it times the device given."""

    __slots__ = ("name", "record", "times", "t0", "device", "event")

    def __init__(self, name: str, device=None):
        self.name = name
        self.record = torch.profiler.record_function(name).__enter__() if _RECORD else None
        self.times = _TIMES
        self.t0 = time.perf_counter_ns() if _TIMES is not None else 0
        self.device = device
        self.event = _cuda_event(device) if _TIMES is not None else None

    def close(self) -> None:
        if self.times is not None:
            self.times.add(self.name, time.perf_counter_ns() - self.t0)
            if self.event is not None:
                end = _cuda_event(self.device)
                if end is not None:
                    self.times.add_events(self.name, self.event, end)
        if self.record is not None:
            self.record.__exit__(None, None, None)


class _Off:
    """A name's shared no-op: a context that does nothing, and a decorator
    whose wrapper opens the name's span at each call while spans are on (a
    device-timed one on the device of the call's first tensor argument)."""

    __slots__ = ("name", "device")

    def __init__(self, name: str, device: bool = False):
        self.name = name
        self.device = device

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        name, device = self.name, self.device

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _ON:
                return fn(*args, **kwargs)
            opened = _Open(name, _device_of(args) if device else None)
            try:
                return fn(*args, **kwargs)
            finally:
                opened.close()

        return spanned


class _Span(_Off):
    """An on span: `with` opens and closes one `_Open`; as a decorator, its
    name's."""

    __slots__ = ("_open",)

    def __enter__(self):
        self._open = _Open(self.name)
        return self

    def __exit__(self, *exc):
        self._open.close()
        return False


_OFF: Dict[tuple, _Off] = {}


def span(name: str, device: bool = False):
    """The span `name`: `with span(name): ...` or `@span(name)`.  Off (no
    switch on), the name's shared no-op; on, a span that opens a
    record_function range (`spans_on`) and adds its host time (`timing`).
    device: as a decorator, under `timing()` the span also adds the device
    time between CUDA events recorded at its open and close, as
    `<name>.device`, where the call's first tensor argument is on a card."""
    if not _ON:
        off = _OFF.get((name, device))
        if off is None:
            off = _OFF.setdefault((name, device), _Off(name, device))
        return off
    return _Span(name, device)


def _set(record=None, times=False, counting=None):
    """Set the switches given; returns the previous three."""
    global _RECORD, _TIMES, _COUNTING, _ON
    saved = (_RECORD, _TIMES, _COUNTING)
    if record is not None:
        _RECORD = record
    if times is not False:
        _TIMES = times
    if counting is not None:
        _COUNTING = counting
    _ON = _RECORD or _TIMES is not None
    return saved


@contextlib.contextmanager
def _switched(**switches):
    saved = _set(**switches)
    try:
        yield
    finally:
        _set(*saved)


def spans_on():
    """Inside the block each span is a `torch.profiler.record_function`
    range."""
    return _switched(record=True)


@contextlib.contextmanager
def timing() -> Iterator[SpanTimes]:
    """Inside the block each span adds its host-clock duration
    (`time.perf_counter_ns`) to the yielded `SpanTimes`, on every thread;
    when the block closes, each device-timed span's events are waited for
    and its device time added (so no span waits for the card inside it)."""
    times = SpanTimes()
    with _switched(times=times):
        yield times
    times.resolve()


def counting():
    """Inside the block the winner kernels (K1, K2) and their plain twins
    add the pairs they evaluate to their wrappers' accumulators
    (`ops.cuda_sweep.pair_counts`)."""
    return _switched(counting=True)


def counting_enabled() -> bool:
    return _COUNTING


def recording_enabled() -> bool:
    """Whether spans are profiler ranges (`spans_on()`)."""
    return _RECORD


def count(name: str) -> None:
    """While `timing()` is on, add one to `name`'s count and nothing to its
    time: how often a path ran, beside the spans' totals."""
    times = _TIMES
    if times is not None:
        times.add(name, 0)


# ---------------------------------------------------------------------------
# a plain-torch layer's backward
# ---------------------------------------------------------------------------


class _Pending:
    """The backward span of one call of a layer, opened by `_GradOut` and
    closed by `_GradIn` on the thread that runs the backward."""

    __slots__ = ("name", "open")

    def __init__(self, name: str):
        self.name = name
        self.open = None

    def start(self) -> None:
        self.open = _Open(self.name) if _ON else None

    def stop(self) -> None:
        if self.open is not None:
            self.open.close()
            self.open = None


class _GradIn(torch.autograd.Function):
    """Applied to a zero-size token before the layer runs, so its backward
    node is older than every node of the layer: autograd's ready queue runs
    the newest ready node first, so this one runs once the layer's nodes
    have run, and closes the span."""

    @staticmethod
    def forward(ctx, pending, token):
        ctx.pending = pending
        return token.view_as(token)

    @staticmethod
    def backward(ctx, _grad):
        ctx.pending.stop()
        return None, None


class _GradOut(torch.autograd.Function):
    """Applied to the layer's outputs: views of them, and a gradient for the
    token, sent when the gradient reaches the outputs (the span opens)."""

    @staticmethod
    def forward(ctx, pending, token, *outputs):
        ctx.set_materialize_grads(False)
        ctx.pending = pending
        ctx.token_grad = token.new_empty(0)
        return tuple(t.view_as(t) for t in outputs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.pending.start()
        return (None, ctx.token_grad) + grads


def _device_of(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
        device = getattr(a, "device", None)
        if isinstance(device, torch.device):
            return device
    return torch.device("cpu")


def backward_span(name: str):
    """Decorator of a layer made of plain torch ops that returns a tensor or
    a tuple: while spans or timing are on and autograd records, its float
    outputs that need a gradient come back as views through `_GradOut`,
    and a token through `_GradIn` is made before the layer runs, so that
    the layer's backward is the span `name`, from the gradient reaching its
    outputs until its last backward node has run.  Neither Function
    launches a device op.  Off, the layer's graph is its own."""

    def decorate(fn):
        @functools.wraps(fn)
        def layer(*args, **kwargs):
            if not _ON or not torch.is_grad_enabled():
                return fn(*args, **kwargs)
            pending = _Pending(name)
            leaf = torch.empty(0, device=_device_of(args), requires_grad=True)
            token = _GradIn.apply(pending, leaf)
            out = fn(*args, **kwargs)
            single = isinstance(out, torch.Tensor)
            outs = (out,) if single else tuple(out)
            slots = [i for i, t in enumerate(outs) if isinstance(t, torch.Tensor)
                     and t.requires_grad and t.is_floating_point()]
            if not slots:
                return out
            views = _GradOut.apply(pending, token, *(outs[i] for i in slots))
            outs = list(outs)
            for i, v in zip(slots, views):
                outs[i] = v
            return outs[0] if single else type(out)(outs)

        return layer

    return decorate


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with spans on; on exit write
    `logdir/trace_<pid>_<ns>.json`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with spans_on(), torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


"""The traced window with the program's own spans, and what they cost.

    python -m portbench.program_spans --workload <name> --seed <n> [--out FILE]

`profile_units` is `tracing.profile_units` with the program's spans on
(`cbtr_tpu_torch/utils/profiling.py::spans_on`) inside the harness's: it
also keeps the host events named `cbtr.*`, with their thread (autograd
issues a CUDA backward from a thread of its own).  `breakdown` labels each
idle gap of the device by the innermost span of either kind that encloses
its middle: the program's where one does, on any thread, the harness's
otherwise; and once more by the innermost span of the thread that runs the
units, which says whether that thread was issuing work or waiting.

The command sets a cell up as `run.py` does and, on the cell's
`trace_units` units, measures what tracing costs on the card: the counted
batch (`counted.py`: timing and counting on) against untraced units before
and after it, then the traced window with the harness's spans alone and
with the program's too, in turns (harness, program, program, harness).  It prints one JSON line last: those times, the breakdown, the
CUDA calls of the traced window that took SLOW_CALL_US or more by program
span (`slow_calls`), the span totals a unit (the host's phases) and the
kernels' pair counts.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Tuple

import torch

from . import counted, tracing

PROGRAM_PREFIX = "cbtr."
SLOW_CALL_US = 200.0


def profile_units(unit, units: int, stages, state, cell):
    """`tracing.profile_units` with the program's spans on; returns (Traced,
    program spans [(name, start, end, thread)], the CUDA API
    calls of SLOW_CALL_US or more [(name, start, end, thread)])."""
    from cbtr_tpu_torch.utils import profiling
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    for _ in range(units):
        unit()
    untraced_s = time.perf_counter() - t0
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with tracing.spans(stages), profiling.spans_on(), profile(activities=activities) as prof:
        with torch.profiler.record_function(tracing.WINDOW_SPAN):
            for _ in range(units):
                with torch.profiler.record_function(tracing.UNIT_SPAN):
                    unit()
    device, host, program, runtime = [], [], [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        on_host = e.device_type != torch.autograd.DeviceType.CUDA
        if e.name.startswith("portbench."):
            if on_host:
                host.append((e.name, a, b))
        elif e.name.startswith(PROGRAM_PREFIX):
            if on_host:
                program.append((e.name, a, b, e.thread))
        elif tracing.is_device_op(e):
            device.append((e.name, a, b))
        elif on_host and e.name.startswith("cu") and b - a >= SLOW_CALL_US:
            runtime.append((e.name, a, b, e.thread))
    window = next((a, b) for n, a, b in host if n == tracing.WINDOW_SPAN)
    traced = tracing.Traced(units=units, window=window, device_ops=device, spans=host,
                            state=state, cell=cell, untraced_s=untraced_s)
    return traced, program, runtime


def slow_calls(runtime, program) -> Dict[str, list]:
    """The CUDA API calls (`cuda*`, `cu*`) of at least SLOW_CALL_US (a launch
    that waits for room in the queue, a copy or a synchronisation that waits
    for the device): [seconds, count] by call and the innermost program span
    of its thread."""
    out = {}
    for name, a, b, thread in runtime:
        inner = _innermost([s for s in program if s[3] == thread], (a + b) / 2.0)
        entry = out.setdefault(f"{name} in {inner or 'no program span'}", [0.0, 0])
        entry[0] += (b - a) / 1e6
        entry[1] += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def _innermost(spans, t):
    """The innermost (latest-starting) of `spans` [(name, start, end, ...)]
    that encloses t, or None."""
    best = None
    for s in spans:
        if s[1] <= t <= s[2] and (best is None or s[1] >= best[1]):
            best = s
    return best[0] if best else None


def _top(totals: Dict[str, float], top: int) -> List[list]:
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]


def breakdown(traced, program: List[Tuple[str, float, float, int]], main_thread=None,
              top: int = 10) -> Dict[str, list]:
    """`tracing.breakdown`'s device ops, its idle gaps labelled by the
    innermost span of either kind (the program's, on any thread, where one
    encloses the gap's middle; the harness's otherwise) and, as
    `idle_gaps_main`, by the innermost program span of `main_thread` (the
    harness's where it is in none)."""
    harness = [s for s in traced.spans if s[0] != tracing.WINDOW_SPAN]
    main = [s for s in program if s[3] == main_thread]
    idle, idle_main = {}, {}
    for a, b in tracing.idle_gaps(traced.device_ops, traced.window):
        t, seconds = (a + b) / 2.0, (b - a) / 1e6
        outside = _innermost(harness, t) or "outside the benchmark's spans"
        for totals, spans in ((idle, program), (idle_main, main)):
            label = _innermost(spans, t) or outside
            totals[label] = totals.get(label, 0.0) + seconds
    return {"device_ops": tracing.breakdown(traced, top)["device_ops"],
            "idle_gaps": _top(idle, top), "idle_gaps_main": _top(idle_main, top)}


def _card() -> dict:
    import subprocess

    if not torch.cuda.is_available():
        return {"card": "cpu"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return {"card": torch.cuda.get_device_name(), "nvidia_smi": smi.stdout.strip()}


def measure(cell, seed: int, device="cuda") -> dict:
    """Set the cell up and measure what tracing costs on its trace_units."""
    from . import run as runner

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = cell.driver.setup(cell, seed, device)
    runner._sync(device)
    units = int(cell.traffic["trace_units"])

    def untraced():
        t0 = time.perf_counter()
        for _ in range(units):
            state.unit()
        return (time.perf_counter() - t0) / units

    # the host's costs first, before any profiler session
    before = untraced()
    batch = counted.run(state.unit, units)
    after = untraced()
    windows = {"harness": [], "program": []}
    traced = labelled = None
    for kind in ("harness", "program", "program", "harness"):
        if kind == "harness":
            t = tracing.profile_units(state.unit, units, state.SPANS, state, cell)
        else:
            t, spans, runtime = profile_units(state.unit, units, state.SPANS, state, cell)
            if labelled is None:
                traced, labelled, slow = t, spans, slow_calls(runtime, spans)
        windows[kind].append(t.window_s)
    main = next((th for n, a, b, th in labelled if n == "cbtr.render"), None)
    return {
        "workload": cell.name, "seed": seed, "units": units, **_card(),
        "window_s": windows,
        "untraced_s_per_unit": [before, after],
        "counted_s_per_unit": batch.seconds / units,
        "spans_ms_per_unit": {k: v[0] / 1e6 / units for k, v in sorted(batch.spans.items())},
        "span_counts_per_unit": {k: v[1] / units for k, v in sorted(batch.spans.items())},
        "pairs_per_unit": {k: [p / units, r / units] for k, (p, r) in batch.pairs.items()},
        "busy_s": traced.busy_s(),
        "breakdown": breakdown(traced, labelled, main),
        "slow_calls": slow,
    }


def main(argv=None) -> int:
    from . import cell as cells
    from . import run as runner

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    cell = cells.find_cell(cells.load_benchmark(), args.workload)
    runner.pin_caches(cell.root)
    if not torch.cuda.is_available():
        print("portbench.program_spans: needs a CUDA device", file=sys.stderr)
        return 2
    line = json.dumps(measure(cell, args.seed))
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

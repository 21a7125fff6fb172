"""Run one cell of the benchmark and print its result as the last line.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds `BENCHMARK.json`.  With --trace 0 the
result's metrics are the cell's end-to-end metrics, measured over a window
of --seconds; with --trace 1 they are its per-layer metrics, read from a
profiler window of the mix's `trace_units` units opened right after set-up.
Both runs then check the outputs against the plain reference (`correct`)
and print each number compared beside its limit, last on standard error and
last in the result's line.  A run that finds no card, or fewer cards than
the cell asks for, fails and prints no result; so does one that ends with
jax, jaxlib, flax or the JAX package loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import cell as cells  # noqa: E402

# top-level module names that no run may load (compared whole: the port's
# name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "cbtr_tpu")


def pin_caches(root: str) -> None:
    """Every build and kernel cache of the program at a fixed path inside the
    checkout: the port builds its libraries into `<root>/build/cbtr_tpu_torch`
    on its own; the caches torch and the CUDA driver keep go under
    `portbench/.cache`."""
    base = os.path.join(root, "portbench", ".cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)
        os.makedirs(os.environ[var], exist_ok=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def judge(numbers: dict, limits: dict):
    """(correct, checks): each number beside its limit; correct when every
    limit has its number and every number is finite and at most its limit."""
    checks = {}
    correct = bool(limits)
    for name in sorted(set(numbers) | set(limits)):
        value = numbers.get(name)
        limit = limits.get(name, {}).get("limit")
        checks[name] = {"value": value, "limit": limit}
        if value is None or limit is None or not math.isfinite(value) or value > limit:
            correct = False
    return correct, checks


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             t0: float = T0) -> dict:
    """Set up, measure (or trace), check; the result's fields."""
    import torch

    from . import tracing, window

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    state = cell.driver.setup(cell, seed, device)
    _sync(device)
    setup_s = time.perf_counter() - t0

    extra, result = {}, {}
    if trace:
        traced = tracing.profile_units(state.unit, int(cell.traffic["trace_units"]),
                                       state.SPANS, state, cell)
        metrics = {}
        for m in cell.per_layer:
            value = cells.metric_reader(cell, m["name"])(traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        attempted, failed = traced.units, 0
        extra = {"busy_s": traced.busy_s(), "window_s": traced.window_s}
        result["breakdown"] = tracing.breakdown(traced)
    else:
        win = window.run(state.unit, seconds)
        values = {"setup_s": setup_s, **state.end_to_end(win)}
        # a name's part before its first dot names the driver's value, so that
        # cells held to different bounds report one quantity under two names
        metrics = {m["name"]: {"value": values[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in cell.end_to_end}
        attempted, failed = len(win.ok), win.ok.count(False)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    measured = time.perf_counter()
    numbers = state.check()
    _sync(device)
    check_s = time.perf_counter() - measured
    correct, checks = judge(numbers, cell.limits)
    result = {
        "correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": int(cell.workload["chips"]), "memory_peak_bytes": int(peak),
                   **extra},
        **result,
        "check_s": check_s,
        # numbers read beside the compared ones, for the calibration
        "readings": getattr(state, "readings", {}),
        "checks": checks,
    }
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = cells.load_benchmark()
    cell = cells.find_cell(bench, args.workload)
    pin_caches(cell.root)
    import torch

    print(f"portbench: torch imported at {time.perf_counter() - T0:.3f} s", file=sys.stderr)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count: {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: modules that no run may load are loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

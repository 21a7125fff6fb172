"""3x3 solve strategies, 1M batched systems: the counterpart of
benchmarks/solve3x3_bench.py (itself after reference/solve3x3.cpp, which
chose inverse-then-multiply over LU: 0.0202 s against 0.2030 s per 1M
solves on a CPU, solve3x3.cpp:5-13).

For N systems m x = v on the device:

* adjugate inverse, then multiply (`geom.inv3x3` + `geom.apply_mat3`, the
  form the intersection's barycentric transforms use);
* `torch.linalg.solve` (batched LU);
* the mat-vec alone on a precomputed inverse (the cost inside the Newton
  loop, where the inverse is built once a patch).

Each is timed over --iters calls after a warm-up (CUDA events on the card,
the host clock on the CPU).

    python -m cbtr_tpu_torch.benchmarks.solve3x3_bench [--n 1000000]
        [--iters 10] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import geom
from . import records


def systems(n: int, device, seed: int = 0):
    """(m [n,3,3], v [n,3]) f32: N(0, 1) entries plus 3 I, so every system is
    well conditioned."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(n, 3, 3)).astype(np.float32) + 3.0 * np.eye(3, dtype=np.float32)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return torch.as_tensor(m, device=device), torch.as_tensor(v, device=device)


def strategies(m, v) -> dict:
    """{strategy: a call that solves m x = v} for the three strategies of the
    module docstring (the precomputed inverse built here, once)."""
    inverse = geom.inv3x3(m)
    return {
        "adjugate inverse + multiply": lambda: geom.apply_mat3(geom.inv3x3(m), v),
        "torch.linalg.solve": lambda: torch.linalg.solve(m, v[..., None])[..., 0],
        "precomputed-inverse mat-vec": lambda: geom.apply_mat3(inverse, v),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=10)
    records.add_output_args(ap)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = records.resolve_device(args.device)
    results = {}
    for name, fn in strategies(*systems(args.n, dev)).items():
        stats = records.window_stats(fn, dev, windows=1, inner=args.iters)
        ms = stats["median_ms"]
        results[name] = {"ms": ms, "solves_per_s": args.n / ms * 1e3}
        print(f"  {name:30s} {ms:8.3f} ms  ({args.n / ms / 1e3:8.1f} M/s)", flush=True)
    records.emit({"metric": f"{args.n} batched 3x3 solves per run", "n": args.n,
                  "iters": args.iters, "results": results, **records.card_fields(dev)},
                 args.out, args.label)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

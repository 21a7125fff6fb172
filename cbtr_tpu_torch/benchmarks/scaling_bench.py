"""Ray-sharded scaling: rays/s of the fwd+bwd train step at 1, 2, 4 ranks.

Counterpart of benchmarks/scaling_bench.py.  For each world size of
--devices it starts that many ranks through `multiprocess_render.launch`
(two `make_multihost_train_step` SGD steps on the sphere lens at --res^2
rays, then --iters timed steps; every rank's parameters equal) and reports
rank 0's rays/s and the efficiency against one rank.

* On the card (the default) a rank is a card under NCCL, so the world sizes
  are clipped to the cards there are: with one card only world 1 runs, and
  the rows above it say "not measured".
* With --device cpu a rank is a CPU process with one thread under gloo;
  those rates are the host's (the record's "platform" says so), never the
  card's.

    python -m cbtr_tpu_torch.benchmarks.scaling_bench [--devices 1,2,4]
        [--res 256] [--iters 5] [--out FILE] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os

import torch

from . import multiprocess_render, records


def run(counts, res: int = 256, iters: int = 5, device: str = "cuda") -> dict:
    """The record: one row a world size (module docstring)."""
    dev = records.resolve_device(device)
    available = torch.cuda.device_count() if dev.type == "cuda" else len(os.sched_getaffinity(0))
    results = []
    for n in counts:
        if n > available:
            results.append({"devices": n, "rays_per_s": "not measured",
                            "efficiency_vs_1dev": "not measured",
                            "why": f"{available} {'cards' if dev.type == 'cuda' else 'cores'} here"})
            continue
        runs = multiprocess_render.launch(n, res=res, mode="train", device=dev.type,
                                          iters=iters)
        head = runs[0]
        rays_s = float(head["rays"]) * iters / float(head["wall_s"])
        results.append({"devices": n, "rays_per_s": round(rays_s, 1)})
        print(f"devices={n}: {rays_s:,.0f} rays/s", flush=True)
    measured = [r for r in results if not isinstance(r["rays_per_s"], str)]
    if measured:
        base = measured[0]["rays_per_s"] / measured[0]["devices"]
        for r in measured:
            r["efficiency_vs_1dev"] = round(r["rays_per_s"] / (base * r["devices"]), 4)
    return {
        "bench": "ray-sharded train-step scaling",
        "rays": res * res,
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "note": "" if dev.type == "cuda" else (
            "gloo ranks on the CPU, one thread each: the host's rates, not a card's"),
        "results": results,
        **records.card_fields(dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--devices", default="1,2,4")
    records.add_output_args(ap)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    counts = [int(c) for c in args.devices.split(",")]
    records.emit(run(counts, args.res, args.iters, args.device), args.out,
                 args.label)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

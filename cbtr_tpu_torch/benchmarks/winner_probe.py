"""K2 at the large-P bench shapes: the kernel, the intersection end to end,
the staged path, and agreement with the plain path.

Counterpart of benchmarks/winner_probe.py.  For each shape (the refined
robot, P = 1800, and the split-4 robot, P = 7200, at 256^2 rays): K2's
wrapper `cuda_winner.sweep_winner` (its tables and one launch),
`intersect_rays` end to end (winner search and differentiable recompute),
the staged path (K3 `cuda_codes.sweep_codes_cuda`, then
`intersect.select_candidates`, K1's retry rule), each timed over --iters
calls; the rays on which the staged winners differ from K2's (K2's
neighbour-sphere gate, ROADMAP queue C); and the agreement of
`intersect_rays` with its plain path (`backend="plain"`, the kernels'
twins) on the first 4,096 rays: what and patch equal, distances within
1e-4 where both hit.

    python -m cbtr_tpu_torch.benchmarks.winner_probe [--shapes refined,split4]
        [--res 256] [--iters 5] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..ops import cuda_codes as cc
from ..ops import cuda_winner as cw
from ..ops import intersect as ix
from . import records

SAMPLE = 4096


def _timed_s(fn, iters: int, device) -> float:
    fn()
    records.sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    records.sync(device)
    return (time.perf_counter() - t0) / iters


def staged(patches, start, direction):
    """(any_hit, win) of the staged path: K3's codes, then select."""
    code, dist = cc.sweep_codes_cuda(patches, start, direction)
    any_hit, win, _ = ix.select_candidates(code, dist, patches.neighbours)
    return any_hit, win


def probe_scene(name: str, scene, iters: int = 5) -> dict:
    """One shape's row (module docstring)."""
    p, s, d = scene.patches, scene.start, scene.direction
    dev = s.device
    R, P = s.shape[0], p.num_patches
    with torch.no_grad():
        t_win = _timed_s(lambda: cw.sweep_winner(p, s, d), iters, dev)
        t_full = _timed_s(lambda: ix.intersect_rays(p, s, d), iters, dev)
        t_staged = _timed_s(lambda: staged(p, s, d), iters, dev)
        k2 = cw.sweep_winner(p, s, d)
        st = staged(p, s, d)
        hp = ix.intersect_rays(p, s[:SAMPLE], d[:SAMPLE])
        hx = ix.intersect_rays(p, s[:SAMPLE], d[:SAMPLE], backend="plain")
    agree = hp.what == hx.what
    both = agree & (hp.what == ix.WHAT_INTERSECT)
    d_ok = torch.isclose(hp.distance[both], hx.distance[both], rtol=1e-4, atol=1e-4)
    patch_ok = hp.patch[both] == hx.patch[both]
    n = hp.what.numel()
    differ = (k2[0] != st[0]) | (k2[0] & st[0] & (k2[1] != st[1]))
    return {
        "shape": name, "rays": R, "patches": P,
        "winner_kernel_ms": round(t_win * 1e3, 3),
        "intersect_full_ms": round(t_full * 1e3, 3),
        "intersect_rays_per_s": round(R / t_full, 1),
        "staged_ms": round(t_staged * 1e3, 3),
        "staged_rays_differ_from_winner": int(differ.sum()),
        "agreement": (int(agree.sum()) - int((~d_ok | ~patch_ok).sum())) / n,
        "agreement_rays": n,
    }


def main(argv=None) -> int:
    from ..models import robot_lens_scene

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default="refined,split4")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--iters", type=int, default=5)
    records.add_output_args(ap)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = records.resolve_device(args.device)
    rows = []
    for name in args.shapes.split(","):
        if name == "refined":
            kw = {"refine": True}
        elif name.startswith("split"):
            kw = {"split": int(name[5:])}
        else:
            raise SystemExit(f"unknown shape {name}")
        rows.append(probe_scene(name, robot_lens_scene(res=args.res, device=dev, **kw),
                                args.iters))
        print(json.dumps(rows[-1]), flush=True)
    records.emit({"shapes": rows, **records.card_fields(dev)}, args.out, args.label)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

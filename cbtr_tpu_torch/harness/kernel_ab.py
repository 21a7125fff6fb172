"""Two checkouts of the port timed against each other on the card, in turns.

    python -m cbtr_tpu_torch.harness.kernel_ab [--against DIR] [--rounds N]

`probe` times a checkout's winner search at the main path's shapes: K1 and
K2 (262,144 x 450 at both refractions of the headline step, 262,144 x 1800
refined, split-4 512^2, split-6 256^2) and K3 (65,536 x 450 and x 1800).
For each: the kernel alone (`launch` on tables built once, K3 on outputs
filled once), its tables alone (`prepare_inputs`), both together (the
wrapper: what the main path pays), the host list builder `tile_block_lists`
at the kernel's block size, and a digest of the wrapper's result.  Then the
tables alone once more for K1, K2 and K3, with the device ops and the
device-busy ms of one `prepare_inputs` under torch.profiler, and the
fixed-lens train step (step size 0) of the headline and of the refined
robot, with its device ops and device-busy ms under torch.profiler, and a
digest of that lens's forward render (the matrix-product splat) and of
`intersect_rays`' fields (the recompute's forward).

--against DIR names the root of another checkout of the repository, e.g.
an earlier commit unpacked by `git archive <commit> | tar -x -C DIR` into an
ignored directory.  Each side then runs in a fresh process from its own
root, in turns DIR, this, this, DIR (`--rounds` times).  That process
imports the root's own package and reaches the kernels only through entry
points both checkouts have (the `prepare_inputs`, `launch` and wrappers of
cuda_sweep, cuda_winner and cuda_codes, `tile_block_lists`,
`make_train_step`, `profile_step._busy`), so neither build's C interface is
assumed.  A row's `same_winners` says whether every run of it gave one
digest (of the winners; for a step row, of the image and the fields).
Without --against this checkout runs once.  Last, the in-kernel cull alone
(`cull_rows`, this checkout).

Every line names the card and its power limit.  It needs a CUDA device and
nvcc; it raises without them.

The imports name the package absolutely: the probe process runs this file
against the other checkout's package.
"""
from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import statistics
import subprocess
import sys

import torch

import cbtr_tpu_torch
from cbtr_tpu_torch.models import lens_model, robot_lens_scene
from cbtr_tpu_torch.ops import cuda_codes as cc
from cbtr_tpu_torch.ops import cuda_sweep as cs
from cbtr_tpu_torch.ops import cuda_winner as cw
from cbtr_tpu_torch.ops import intersect as ix
from cbtr_tpu_torch.render import render as rd

# the root of the checkout this file belongs to
THIS_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (label, robot_lens_scene arguments, refraction pass 1 or 2, kernel)
WINNER_SHAPES = (
    ("262,144 x 450, 1st pass", {"res": 512}, 1, "K1"),
    ("262,144 x 450, 2nd pass", {"res": 512}, 2, "K1"),
    ("262,144 x 1800, refined", {"res": 512, "refine": True}, 1, "K2"),
    ("262,144 x 7200, split-4 512^2", {"res": 512, "split": 4}, 1, "K2"),
    ("65,536 x 16,200, split-6 256^2", {"res": 256, "split": 6}, 1, "K2"),
)
# K3 on the first 65,536 rays of the 512^2 grid (the bench's breakdown)
K3_SHAPES = (("65,536 x 450 (K3)", {}), ("65,536 x 1800, refined (K3)", {"refine": True}))
# the tables alone (`prepare_inputs`, with its device ops): (label, scene
# arguments, rays, kernel)
TABLE_SHAPES = (
    ("prepare_inputs alone, 262,144 x 450 (K1)", {}, 262144, "K1"),
    ("prepare_inputs alone, 262,144 x 1800 (K2)", {"refine": True}, 262144, "K2"),
    ("prepare_inputs alone, 65,536 x 450 (K3)", {}, 65536, "K3"),
)
STEP_SCENES = (("headline step, robot 512^2", {}), ("refined step, robot 512^2", {"refine": True}))

# `python -c` program of the probe process: runs this file, with --probe,
# against the package of its working directory
_RUN_PROBE = ("import runpy, sys; sys.argv = [sys.argv[1], '--probe']; "
              "runpy.run_path(sys.argv[0], run_name='__main__')")


def time_ms(fn, windows: int = 7, inner: int = 3, warmup: int = 2) -> float:
    """Median over `windows` of the mean time of `inner` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(inner):
            fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / inner)
    return statistics.median(times)


def digest(*tensors) -> str:
    """A digest of the tensors' values (copied to the host)."""
    h = hashlib.sha1()
    for t in tensors:
        h.update(str(t.dtype).encode())
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def second_pass_rays(scene):
    """The rays the lens's forward render hands its second refraction's
    winner search (captured at `intersect._winner_chunk`)."""
    seen = []
    search = ix._winner_chunk

    def record(patches, start, direction, *args, **kwargs):
        seen.append((start.clone(), direction.clone()))
        return search(patches, start, direction, *args, **kwargs)

    ix._winner_chunk = record
    try:
        with torch.no_grad():
            rd.render_lens_image(scene.patches, scene.refractive_index, scene.start,
                                 scene.direction, scene.screen_plane, resolution=128)
    finally:
        ix._winner_chunk = search
    assert len(seen) == 2, len(seen)
    return seen[1]


def _call_times(prepare, launcher, wrapper, block_p, patches, start, direction) -> dict:
    """One kernel at one shape: alone (`launcher(inputs)` is the launch on
    tables built once), its tables, both (the wrapper), the list builder."""
    inputs = prepare(patches, start, direction)
    rays_t = cs.pad_rays(start.to(torch.float32), direction.to(torch.float32))
    return {"digest": digest(*wrapper(patches, start, direction)),
            "alone_ms": time_ms(launcher(inputs)),
            "tables_ms": time_ms(lambda: prepare(patches, start, direction)),
            "with_tables_ms": time_ms(lambda: wrapper(patches, start, direction)),
            "lists_ms": time_ms(lambda: cs.tile_block_lists(patches, rays_t, block_p),
                                windows=5)}


def probe(device) -> dict:
    """{label: numbers} of this process's package at every shape (module
    docstring); scenes are built one at a time."""
    from cbtr_tpu_torch.harness.profile_step import _busy

    out = {}
    for label, kw, refraction, kernel in WINNER_SHAPES:
        sc = robot_lens_scene(device=device, **kw)
        s, d = (sc.start, sc.direction) if refraction == 1 else second_pass_rays(sc)
        mod, wrapper = (cs, cs.sweep_select) if kernel == "K1" else (cw, cw.sweep_winner)
        out[label] = _call_times(mod.prepare_inputs, lambda i, m=mod: functools.partial(
            m.launch, i), wrapper, cs.BLOCK_P, sc.patches, s, d)
        del sc, s, d
        torch.cuda.empty_cache()
    for label, kw in K3_SHAPES:
        sc = robot_lens_scene(res=512, device=device, **kw)
        s, d = sc.start[:65536], sc.direction[:65536]
        out[label] = _call_times(cc.prepare_inputs, lambda i: functools.partial(
            cc.launch, i, cc.filled_outputs(i)), cc.sweep_codes_cuda, cc.BLOCK_P,
            sc.patches, s, d)
        del sc, s, d
        torch.cuda.empty_cache()
    for label, kw, rays, kernel in TABLE_SHAPES:
        sc = robot_lens_scene(res=512, device=device, **kw)
        prepare = {"K1": cs, "K2": cw, "K3": cc}[kernel].prepare_inputs

        def tables():
            return prepare(sc.patches, sc.start[:rays], sc.direction[:rays])

        out[label] = {"tables_ms": time_ms(tables), **_busy(tables, True)}
        del sc
        torch.cuda.empty_cache()
    for label, kw in STEP_SCENES:
        sc = robot_lens_scene(res=512, device=device, **kw)
        target = torch.zeros((128, 128), dtype=torch.float32, device=device)
        step = lens_model.make_train_step(sc.screen_plane, target, resolution=128,
                                          learning_rate=0.0)
        params = lens_model.params_from_scene(sc)

        def run():
            return step(params, sc.start, sc.direction)

        with torch.no_grad():
            img = rd.render_lens_image(sc.patches, sc.refractive_index, sc.start,
                                       sc.direction, sc.screen_plane, resolution=128)
            hit = ix.intersect_rays(sc.patches, sc.start, sc.direction)
        out[label] = {"digest": digest(img, *hit), "step_ms": time_ms(run, windows=5, inner=2),
                      **_busy(run, True)}
        del img, hit
        del sc, params, step
        torch.cuda.empty_cache()
    return out


def run_checkout(root: str) -> dict:
    """`probe` in a fresh process that imports the package of the checkout
    at `root`; raises if it fails."""
    proc = subprocess.run([sys.executable, "-c", _RUN_PROBE, os.path.abspath(__file__)],
                          cwd=root, capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"the probe of {root} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def merge(results) -> list[dict]:
    """[(side, probe result)] in turn order -> one row per label: each side's
    numbers in turn order, and `same_winners` where the probe took digests."""
    rows = {}
    for side, result in results:
        for label, numbers in result.items():
            row = rows.setdefault(label, {"shape": label})
            for key, value in numbers.items():
                row.setdefault(side, {}).setdefault(key, []).append(value)
    for row in rows.values():
        digests = {d for side in row.values() if isinstance(side, dict)
                   for d in side.pop("digest", [])}
        if digests:
            row["same_winners"] = len(digests) == 1
    return list(rows.values())


def compare_checkouts(against: str = "", rounds: int = 1) -> list[dict]:
    """This checkout, alone or in turns with the one at `against` (module
    docstring), merged by `merge`."""
    if not against:
        return merge([("this", run_checkout(THIS_ROOT))])
    order = [("against", against), ("this", THIS_ROOT), ("this", THIS_ROOT),
             ("against", against)] * rounds
    return merge([(side, run_checkout(root)) for side, root in order])


def cull_rows(device):
    """The in-kernel cull alone: K1 and K2 on rays turned away from the lens
    (every direction negated), where the cull lists no block (the row says
    how many it listed), so the launch is the cull, the staging set-up and
    the output; at the headline and at 16,200 patches (split-6) with 512^2
    rays."""
    rows = []
    for label, stem, kw in (("262,144 x 450", "sweep_select", {}),
                            ("262,144 x 16,200 (split-6 512^2)", "winner", {"split": 6})):
        sc = robot_lens_scene(res=512, device=device, **kw)
        prepare = cw.prepare_inputs if stem == "winner" else cs.prepare_inputs
        inputs = prepare(sc.patches, sc.start, -sc.direction)
        listed = int(cs.launch_kernel(stem, inputs).counts.sum())
        rows.append({"shape": label, "kernel": stem, "listed_blocks": listed,
                     "cull_only_ms": time_ms(lambda: cs.launch_kernel(stem, inputs))})
        del sc, inputs
        torch.cuda.empty_cache()
    return rows


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", default="", help="root of another checkout")
    ap.add_argument("--rounds", type=int, default=1, help="turns of 4 runs each")
    ap.add_argument("--probe", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.probe:
        print(f"[probe] {os.path.dirname(cbtr_tpu_torch.__file__)}", file=sys.stderr,
              flush=True)
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_ab needs a CUDA device")
    # the splat is an f32 matrix product: TF32 would change the image
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.probe:
        print(json.dumps(probe(torch.device("cuda", 0))), flush=True)
        return 0
    name = card()
    for row in compare_checkouts(args.against, args.rounds):
        print(f"[ab] {name} | {json.dumps(row)}", flush=True)
    for row in cull_rows(torch.device("cuda", 0)):
        print(f"[ab] {name} | {json.dumps(row)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

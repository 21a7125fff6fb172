"""Two checkouts of the port timed against each other on the card, in turns.

    python -m cbtr_tpu_torch.harness.kernel_ab [--against DIR] [--rounds N]
        [--segment-sum-only | --tables-only | --recompute-only]

`probe` times a checkout's winner search at the main path's shapes: K1 and
K2 (262,144 x 450 at both refractions of the headline step, 262,144 x 1800
refined, split-4 512^2, split-6 256^2) and K3 (65,536 x 450 and x 1800).
For each: the kernel alone (`launch` on tables built once, K3 on outputs
filled once), its tables alone (`prepare_inputs`), both together (the
wrapper: what the main path pays), the host list builder `tile_block_lists`
at the kernel's block size, and a digest of the wrapper's result.  Then the
tables alone once more for K1, K2 and K3, with the device ops, the
device-busy ms and the device ms by kernel of one `prepare_inputs` under
torch.profiler; the table kernel alone (`cuda_tables.build_tables` at block
16 on the robot, the refined robot and split-6: P = 450, 1800, 16,200) and
the ray table alone (`cuda_tables.pack_rays`, or `cuda_sweep.pad_rays`
where a checkout has no ray-pack kernel, at 262,144 and 1,048,576 rays of the
4096^2 grid), each with a digest of its output, its CUDA-event time, the
host time to issue it, and its device ops and device ms by kernel per call
(the kernel's own device time: `KERNEL_NAMES`); and the
fixed-lens train step (step size 0) of the headline and of the refined
robot, with its device ops and device-busy ms under torch.profiler, and a
digest of that lens's forward render (the matrix-product splat) and of
`intersect_rays`' fields (the recompute's forward) and of one step's
gradients.  First, the segment sum
(`cuda_segment.launch`) at the headline recompute's backward, a 4K chunk's,
a 4K render's splat and a seeded splat (`segment_sum_inputs`): a digest of
its output, its time, device ops, busy ms and peak memory.  With
--segment-sum-only the probe stops there (and the cull rows are left out);
--tables-only runs the table, ray and `prepare_inputs` rows alone.  The
recompute (`recompute_rows`, `intersect.recompute_winner` forward alone and
with its backward, at the headline, the refined robot and a 4K chunk) comes
after the tables, with a digest of its fields (`same_winners`) and of its
gradients (`reproducible_gradients` within a side, `same_gradients` across
the sides); --recompute-only runs it alone.

--against DIR names the root of another checkout of the repository, e.g.
an earlier commit unpacked by `git archive <commit> | tar -x -C DIR` into an
ignored directory.  Each side then runs in a fresh process from its own
root, in turns DIR, this, this, DIR (`--rounds` times).  That process
imports the root's own package and reaches the kernels only through entry
points both checkouts have (the `prepare_inputs`, `launch` and wrappers of
cuda_sweep, cuda_winner and cuda_codes, `cuda_tables.build_tables`,
`pad_rays`, `cuda_segment.launch`, `tile_block_lists`, `scene_ortho_grid`,
`make_train_step`, `profile_step._busy`), so neither build's C interface is
assumed.  A row's `same_winners` says whether every run of it gave one
digest (of the winners; for a step row, of the image and the fields; for a
segment-sum row, of its output).
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
import time

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
# the table kernel alone at block 16: (label, scene arguments; the rays unused)
TABLE_KERNEL_SHAPES = (
    ("tables alone, P = 450", {"res": 16}),
    ("tables alone, P = 1800", {"res": 16, "refine": True}),
    ("tables alone, P = 16,200", {"res": 16, "split": 6}),
)
# the ray table alone: (label, the first rays of the 4096^2 grid)
RAY_SHAPES = (("ray pack alone, 262,144", 1 << 18), ("ray pack alone, 1,048,576", 1 << 20))
# calls a profiler session of a table or ray row makes (its numbers are per call)
TABLE_CALLS = 20
STEP_SCENES = (("headline step, robot 512^2", {}), ("refined step, robot 512^2", {"refine": True}))

# `python -c` program of the probe process: runs this file, with --probe,
# against the package of its working directory
_RUN_PROBE = ("import runpy, sys; sys.argv = [sys.argv[1], '--probe'] + sys.argv[2:]; "
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


def segment_sum_inputs(device) -> dict:
    """{label: (ids, vals, num_segments)}: the segment sum at the main path's
    shapes, made the same in every checkout: the headline recompute's
    backward (K1's winners of the robot 512^2 grid, misses at patch 0, 60
    seeded normal columns), a 4K chunk's (the first 1,048,576 rays of the
    4096^2 grid), the splat of a 4K render (its pixel ids and contributions,
    captured) and a seeded splat of 67,108,864 contributions into 1024^2
    with 22 % of them on the centre pixel (as the 4K render's dead rays)."""
    from cbtr_tpu_torch.models import scene_ortho_grid
    from cbtr_tpu_torch.parallel.multihost import multihost_mesh, render_multihost_ortho

    gen = torch.Generator(device=device).manual_seed(0)
    sc = robot_lens_scene(res=512, device=device)
    P = sc.patches.num_patches
    win = cs.sweep_select(sc.patches, sc.start, sc.direction)[1].clamp_min(0).to(torch.int64)
    grid = scene_ortho_grid(4096)
    s4, d4 = grid.rays_at(torch.arange(1 << 20, device=device))
    win4 = cs.sweep_select(sc.patches, s4, d4)[1].clamp_min(0).to(torch.int64)
    captured, real = [], rd.segment_sum

    def capture(ids, vals, n):
        captured.append((ids, vals, n))
        return real(ids, vals, n)

    rd.segment_sum = capture
    try:
        with torch.no_grad():
            render_multihost_ortho(multihost_mesh(), sc.patches, sc.refractive_index, grid,
                                   sc.screen_plane, resolution=1024, chunk_size=1 << 20)
    finally:
        rd.segment_sum = real
    (splat,) = captured
    n, pixels = 1 << 26, 1 << 20
    hot = torch.rand(n, generator=gen, device=device) < 0.22
    seeded = torch.where(hot, pixels // 2 + 512,
                         torch.randint(0, pixels, (n,), generator=gen, device=device))
    return {
        "segment_sum 262,144 x 60 -> 450 (headline recompute)":
            (win, torch.randn((win.numel(), 60), generator=gen, device=device), P),
        "segment_sum 1,048,576 x 60 -> 450 (4K chunk recompute)":
            (win4, torch.randn((win4.numel(), 60), generator=gen, device=device), P),
        "segment_sum 67,108,864 x 1 -> 1024^2 (4K render's splat)": splat,
        "segment_sum 67,108,864 x 1 -> 1024^2 (seeded, hot centre pixel)":
            (seeded.to(torch.int32), torch.randn((n, 1), generator=gen, device=device), pixels),
    }


# the segment sum's kernels (csrc/segment_sum.cu), by the names
# `device_kernels` files their device time under
SEGMENT_KERNELS = ("Memset", "tile_histogram", "scan_digits", "tile_scatter", "segment_bounds",
                   "scan_nodes", "fold_values", "fold_rows")


# the table kernel and the ray-pack kernel (csrc/tables.cu), by the names
# `device_kernels` files their device time under
TABLE_KERNELS = ("tables_kernel", "pack_rays_kernel")
# the recompute's forward and backward kernels (csrc/recompute.cu)
RECOMPUTE_KERNELS = ("recompute_forward_kernel", "recompute_backward_kernel")
KERNEL_NAMES = SEGMENT_KERNELS + TABLE_KERNELS + RECOMPUTE_KERNELS


# the kernels every segment sum of this checkout launches (a fold at each level)
SEGMENT_STAGES = ("Memset", "tile_histogram", "scan_digits", "tile_scatter", "scan_nodes",
                  "fold_")


def _this_package() -> bool:
    """Whether the imported package is this file's checkout's (and not the
    one a probe process of `--against` runs this file against)."""
    return (os.path.dirname(os.path.abspath(cbtr_tpu_torch.__file__))
            == os.path.join(THIS_ROOT, "cbtr_tpu_torch"))


def device_kernels(fn, stages=(), tries: int = 12):
    """(device ops, busy ms, {kernel: device ms}, sessions) of one call of fn
    under torch.profiler (busy: the union of the ops' intervals); the
    port's kernels by name (KERNEL_NAMES), the rest by the profiler's
    (`_op_name`).  The profiler can drop device records, so a session counts
    only when it saw some device op, as many as an earlier session did, and
    a kernel of each name in `stages`; up to `tries` sessions (`sessions`:
    how many it took), then raises with the counts it saw."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        named = all(any(s in e.name for e in ops) for s in stages)
        if ops and len(ops) in seen and named:
            break
        seen.append(len(ops))
    else:
        raise RuntimeError(f"torch.profiler gave no two sessions with the same device ops "
                           f"and the stages {stages} in {tries} sessions (device ops: {seen})")
    per, busy, end = {}, 0.0, float("-inf")
    for e in sorted(ops, key=lambda e: e.time_range.start):
        a, b = e.time_range.start, e.time_range.end
        key = next((k for k in KERNEL_NAMES if k in e.name), _op_name(e.name))
        per[key] = per.get(key, 0.0) + (b - a) / 1e3
        if b > end:
            busy += b - max(a, end)
            end = b
    return len(ops), busy / 1e3, per, len(seen) + 1


def _op_name(name: str) -> str:
    """A torch kernel's name without its return type, parameters and the
    arguments after its functor: "vectorized_elementwise_kernel<4,
    FillFunctor<float>" tells a fill from a copy where 40 characters do not.
    A kernel of an anonymous namespace (the port's) goes by its own name."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    name = name.split("(")[0].replace("at::native::", "")
    return name[:72]


def host_ms(fn, calls: int = 50) -> float:
    """Host ms to issue one call of fn (the host clock around `calls` calls,
    no synchronisation in between; the device drains after)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / calls * 1e3


def _per_call(fn, calls: int = TABLE_CALLS) -> dict:
    """fn's device ops, busy ms and device ms by kernel per call, from one
    profiler session of `calls` calls (`device_kernels`)."""
    ops, busy, per, sessions = device_kernels(lambda: [fn() for _ in range(calls)])
    return {"device_ops": ops / calls, "busy_ms": busy / calls,
            "kernels_ms": {k: v / calls for k, v in per.items()},
            "profiler_sessions": sessions}


def table_rows(device) -> dict:
    """{label: numbers}: the table kernel alone at TABLE_KERNEL_SHAPES and the
    ray table alone at RAY_SHAPES (module docstring)."""
    from cbtr_tpu_torch.models import scene_ortho_grid
    from cbtr_tpu_torch.ops import cuda_tables as ct

    out = {}
    for label, kw in TABLE_KERNEL_SHAPES:
        patches = robot_lens_scene(device=device, **kw).patches

        def build():
            return ct.build_tables(patches, cs.BLOCK_P)

        out[label] = {"digest": digest(*build()), "patches": patches.num_patches,
                      "ms": time_ms(build), "host_ms": host_ms(build), **_per_call(build)}
    # a checkout without the ray-pack kernel packs the rays with plain torch
    # ops on its CUDA path (`pad_rays`)
    pack = getattr(ct, "pack_rays", cs.pad_rays)
    grid = scene_ortho_grid(4096)
    for label, rays in RAY_SHAPES:
        s, d = grid.rays_at(torch.arange(rays, device=device))

        def packed():
            return pack(s, d)

        out[label] = {"digest": digest(packed()), "pack": pack.__name__, "ms": time_ms(packed),
                      "host_ms": host_ms(packed), **_per_call(packed)}
        del s, d
    torch.cuda.empty_cache()
    return out


def segment_sum_rows(device) -> dict:
    """{label: numbers}: `cuda_segment.launch` at `segment_sum_inputs`' shapes:
    a digest of its output, its time, device ops, busy ms and device ms by
    kernel (`device_kernels`; the stages are checked by name in this
    checkout only: another builds the sum from other kernels) and its peak
    memory above its inputs."""
    from cbtr_tpu_torch.ops import cuda_segment as sg

    stages = SEGMENT_STAGES if _this_package() else ()
    out = {}
    for label, (ids, vals, S) in segment_sum_inputs(device).items():
        def call():
            return sg.launch(ids, vals, S)

        row = {"digest": digest(call())}
        big = ids.numel() >= 1 << 24
        row["ms"] = time_ms(call, windows=5 if big else 7, inner=1 if big else 3)
        (row["device_ops"], row["busy_ms"], row["kernels_ms"],
         row["profiler_sessions"]) = device_kernels(call, stages)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        call()
        torch.cuda.synchronize()
        row["peak_gib"] = (torch.cuda.max_memory_allocated() - before) / 2**30
        out[label] = row
    torch.cuda.empty_cache()
    return out


# the recompute at the main path's shapes: (label, robot_lens_scene arguments
# or None for the first 1,048,576 rays of the 4096^2 grid on the robot)
RECOMPUTE_SHAPES = (("recompute 262,144 x 450 (headline, K1's winners)", {"res": 512}),
                    ("recompute 262,144 x 1800 (refined, K2's winners)",
                     {"res": 512, "refine": True}),
                    ("recompute 1,048,576 x 450 (4K chunk, K1's winners)", None))


def recompute_rows(device) -> dict:
    """{label: numbers}: `intersect.recompute_winner` (the entry point every
    checkout has) at RECOMPUTE_SHAPES on the winners of the checkout's own
    winner search, forward alone (no grad) and forward with the backward of
    a seeded cotangent of the point, normal and cos_incidence: a digest of
    the forward's fields (`digest`: the same in every checkout whose forward
    is bit-equal) and of the gradients (`grad_digest`: the same within a
    checkout), the time of each (CUDA events), its device ops and device-busy
    ms (torch.profiler), the device ms by kernel a call over 20 calls
    (`_per_call`: the recompute kernels' own time) and the peak memory above
    the inputs of the forward with its backward."""
    from cbtr_tpu_torch.harness.profile_step import _busy
    from cbtr_tpu_torch.models import scene_ortho_grid

    out = {}
    for label, kw in RECOMPUTE_SHAPES:
        sc = robot_lens_scene(device=device, **(kw or {"res": 1}))
        if kw is None:
            s, d = scene_ortho_grid(4096).rays_at(torch.arange(1 << 20, device=device))
        else:
            s, d = sc.start, sc.direction
        patches = sc.patches
        search = cs.sweep_select if patches.num_patches <= cs._FUSED_MAX_P else cw.sweep_winner
        with torch.no_grad():
            any_hit, win, _ = search(patches, s, d)
        gen = torch.Generator(device=device).manual_seed(0)
        g_pt, g_n = (torch.randn((s.shape[0], 3), generator=gen, device=device)
                     for _ in range(2))
        g_cos = torch.randn(s.shape[0], generator=gen, device=device)
        leaves = patches.map(lambda t: t.detach().requires_grad_(t.is_floating_point()))

        def forward():
            with torch.no_grad():
                return ix.recompute_winner(patches, s, d, any_hit, win)

        def step():
            for t in leaves.leaves().values():
                t.grad = None
            hit = ix.recompute_winner(leaves, s, d, any_hit, win)
            ok = (hit.what == ix.WHAT_INTERSECT)[:, None]
            ((torch.where(ok, hit.point, 0.0) * g_pt).sum()
             + (torch.where(ok, hit.normal, 0.0) * g_n).sum()
             + (torch.where(ok[:, 0], hit.cos_incidence, 0.0) * g_cos).sum()).backward()
            return [t.grad for k, t in leaves.leaves().items() if k != "neighbours"]

        row = {"digest": digest(*forward()), "grad_digest": digest(*step())}
        row["forward_ms"] = time_ms(forward, windows=5, inner=2)
        row["step_ms"] = time_ms(step, windows=5, inner=1)
        row["forward_profile"] = _busy(forward, True)
        row["step_profile"] = _busy(step, True)
        # each kernel's own device time a call (the recompute kernels by name)
        row["forward_per_call"] = _per_call(forward)
        row["step_per_call"] = _per_call(step)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        step()
        torch.cuda.synchronize()
        row["step_peak_gib"] = (torch.cuda.max_memory_allocated() - before) / 2**30
        out[label] = row
        del sc, s, d, leaves, patches
        torch.cuda.empty_cache()
    return out


def prepare_rows(device) -> dict:
    """{label: numbers}: `prepare_inputs` alone at TABLE_SHAPES, its time and
    its device ops, busy ms and device ms by kernel per call."""
    out = {}
    for label, kw, rays, kernel in TABLE_SHAPES:
        sc = robot_lens_scene(res=512, device=device, **kw)
        prepare = {"K1": cs, "K2": cw, "K3": cc}[kernel].prepare_inputs

        def tables():
            return prepare(sc.patches, sc.start[:rays], sc.direction[:rays])

        out[label] = {"tables_ms": time_ms(tables), "host_ms": host_ms(tables),
                      **_per_call(tables)}
        del sc
        torch.cuda.empty_cache()
    return out


def probe(device, segment_sum_only: bool = False, tables_only: bool = False,
          recompute_only: bool = False) -> dict:
    """{label: numbers} of this process's package at every shape (module
    docstring), or at the segment sum's only, or at the tables' only, or at
    the recompute's only; scenes are built one at a time."""
    from cbtr_tpu_torch.harness.profile_step import _busy

    if tables_only:
        return {**table_rows(device), **prepare_rows(device)}
    if recompute_only:
        return recompute_rows(device)
    out = segment_sum_rows(device)
    if segment_sum_only:
        return out
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
    out.update(table_rows(device))
    out.update(prepare_rows(device))
    out.update(recompute_rows(device))
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
        stepped, _ = run()
        grads = (stepped.control_points.grad, stepped.refractive_index.grad)
        out[label] = {"digest": digest(img, *hit, *grads),
                      "step_ms": time_ms(run, windows=5, inner=2), **_busy(run, True)}
        del img, hit, stepped, grads
        del sc, params, step
        torch.cuda.empty_cache()
    return out


def run_checkout(root: str, segment_sum_only: bool = False, tables_only: bool = False,
                 recompute_only: bool = False) -> dict:
    """`probe` in a fresh process that imports the package of the checkout
    at `root`; raises if it fails."""
    extra = (["--segment-sum-only"] if segment_sum_only else []) + (
        ["--tables-only"] if tables_only else []) + (
        ["--recompute-only"] if recompute_only else [])
    proc = subprocess.run([sys.executable, "-c", _RUN_PROBE, os.path.abspath(__file__), *extra],
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
        grads = [set(side.pop("grad_digest")) for side in row.values()
                 if isinstance(side, dict) and "grad_digest" in side]
        if grads:
            row["reproducible_gradients"] = all(len(g) == 1 for g in grads)
            row["same_gradients"] = len(set().union(*grads)) == 1
    return list(rows.values())


def compare_checkouts(against: str = "", rounds: int = 1, segment_sum_only: bool = False,
                      tables_only: bool = False, recompute_only: bool = False) -> list[dict]:
    """This checkout, alone or in turns with the one at `against` (module
    docstring), merged by `merge`."""
    order = [("this", THIS_ROOT)]
    if against:
        order = [("against", against), ("this", THIS_ROOT), ("this", THIS_ROOT),
                 ("against", against)] * rounds
    return merge([(side, run_checkout(root, segment_sum_only, tables_only, recompute_only))
                  for side, root in order])


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
    ap.add_argument("--segment-sum-only", action="store_true",
                    help="time the segment sum's rows alone")
    ap.add_argument("--tables-only", action="store_true",
                    help="time the table, ray and prepare_inputs rows alone")
    ap.add_argument("--recompute-only", action="store_true",
                    help="time the recompute rows alone")
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
        print(json.dumps(probe(torch.device("cuda", 0), args.segment_sum_only,
                               args.tables_only, args.recompute_only)), flush=True)
        return 0
    name = card()
    for row in compare_checkouts(args.against, args.rounds, args.segment_sum_only,
                                 args.tables_only, args.recompute_only):
        print(f"[ab] {name} | {json.dumps(row)}", flush=True)
    if args.segment_sum_only or args.tables_only or args.recompute_only:
        return 0
    for row in cull_rows(torch.device("cuda", 0)):
        print(f"[ab] {name} | {json.dumps(row)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Stage profile of the robot-lens render and train step.

Where the time of one forward render and one SGD step goes, at the
headline shape by default (robot.stl, 450 patches, res x res collimated
rays, 128 x 128 image, zero target):

* per stage, summed over its calls in one forward: the device span (CUDA
  events recorded around each call) and the host time to issue it (host
  clock, no synchronisation), mean over --runs forwards;
* the forward with grad and the backward alone (CUDA events, median of
  --runs), the same stages inside the backward (the recompute re-run by a
  chunk's checkpoint on the plain version; on the kernels no chunk is
  checkpointed: the recompute's backward kernel, the segment sums of its
  row gradients), and the step's peak device memory; the recompute's
  forward and backward kernels are stages of their own
  (`cuda_recompute.launch_forward`, `launch_backward`: on the card only);
* torch.profiler over one forward and one step: device ops run and the
  device's busy time (the union of their intervals), set against the
  unprofiled wall time; the same, with the device ms by kernel, per call
  of a table build (`cuda_tables.build_tables`, once a lens a trace) and
  of one chunk's `prepare_inputs` on those tables (the ray pack), 20 calls
  a session under `kernel_ab.device_kernels`' rule (a session counts when
  it saw as many device ops as an earlier one: the profiler can drop a
  short call's), before any long session;
* the fraction of (tile x block) pairs K1's cull lists (the kernel's own
  per-tile counts on the card).

    python -m cbtr_tpu_torch.harness.profile_step [--res 512] [--runs 5]
        [--chunk 0] [--device cuda] [--out profile.json] [--label TEXT]

--chunk N scans the rays in chunks of N, as the 4096^2 scripts do
(`python -m cbtr_tpu_torch.harness.profile_step --res 4096 --chunk 1048576`
profiles their render and step); the tables and the listed fraction are
then those of the first chunk.

It runs on the card and raises where there is none.  --device cpu (for
debugging at a small --res) takes the host times only.  The record (with
the command, the card and its power limit) goes out through
`benchmarks/records.py`, its JSON last.
"""
from __future__ import annotations

import argparse
import contextlib
import statistics
import sys
import time

import torch

from ..benchmarks import records
from ..models import lens_model, robot_lens_scene
from ..ops import cuda_recompute as cr
from ..ops import cuda_segment as sg
from ..ops import cuda_sweep as cs
from ..ops import cuda_tables as ct
from ..ops import intersect as ix
from ..render import render as rd

# (label, module, attribute): each is called through its module's global,
# so wrapping the attribute wraps every call of the path
STAGES = (
    ("trace_through_lens", rd, "trace_through_lens"),
    ("recompute_winner", ix, "recompute_winner"),
    ("winner_search", ix, "_winner_chunk"),
    # the kernels' tables, once a lens a trace; a chunk's ray table
    ("tables", ct, "build_tables"),
    ("k1_rays", ct, "pack_rays"),
    ("k1_launch", cs, "launch"),
    ("screen_hits", rd, "screen_hits"),
    ("splat_bilinear", rd, "splat_bilinear"),
    # the fixed-order sums: the scatter splat's, the recompute's row gradients
    ("segment_sum", sg, "_sum"),
    # the recompute's two kernels (on the card; its plain version on the CPU)
    ("recompute_forward", cr, "launch_forward"),
    ("recompute_backward", cr, "launch_backward"),
)


@contextlib.contextmanager
def stage_spans(cuda: bool):
    """Wrap every stage; yields {label: [([start, end] CUDA events or None,
    host seconds) per call]}."""
    spans = {label: [] for label, _, _ in STAGES}
    saved = []

    def wrap(label, fn):
        def timed(*args, **kwargs):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else None
            if cuda:
                ev[0].record()
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                # also when fn raises: a checkpoint's recompute in the
                # backward stops by an exception once it has what it needs
                host = time.perf_counter() - t
                if cuda:
                    ev[1].record()
                spans[label].append((ev, host))
        return timed

    for label, mod, attr in STAGES:
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, wrap(label, getattr(mod, attr)))
    try:
        yield spans
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _sync(cuda: bool):
    if cuda:
        torch.cuda.synchronize()


def _median_ms(fn, cuda: bool, runs: int) -> float:
    times = []
    for _ in range(runs):
        _sync(cuda)
        if cuda:
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            fn()
            t1.record()
            torch.cuda.synchronize()
            times.append(t0.elapsed_time(t1))
        else:
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _kernels(fn, cuda: bool) -> dict:
    """Device ops, busy ms and device ms by kernel per call of fn under
    torch.profiler (`kernel_ab._per_call`: 20 calls a session, by
    `kernel_ab.device_kernels`' rule)."""
    if not cuda:
        return {"device_ops": None, "busy_ms": None, "kernels_ms": None}
    from .kernel_ab import _per_call

    return _per_call(fn)


def _busy(fn, cuda: bool) -> dict:
    """Device ops and busy ms of one call under torch.profiler."""
    if not cuda:
        return {"device_ops": None, "busy_ms": None}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ranges = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in ranges:            # union of the kernels' intervals, in us
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"device_ops": len(ranges), "busy_ms": busy / 1e3 if ranges else None}


def _stage_means(per_run, cuda: bool) -> dict:
    """{label: calls, mean device ms, mean host ms} over the runs' spans."""
    return {label: {"calls": per_run[0][label][2],
                    "device_ms": statistics.mean(r[label][0] for r in per_run) if cuda else None,
                    "host_ms": statistics.mean(r[label][1] for r in per_run)}
            for label, _, _ in STAGES}


def _span_sums(spans, cuda: bool, skip=None) -> dict:
    """{label: (device ms, host ms, calls)} of the spans' calls (after the
    first skip[label] of each)."""
    out = {}
    for label, calls in spans.items():
        calls = calls[(skip or {}).get(label, 0):]
        out[label] = (sum(ev[0].elapsed_time(ev[1]) for ev, _ in calls) if cuda else None,
                      sum(host for _, host in calls) * 1e3, len(calls))
    return out


def _run_spans(fn, cuda: bool) -> dict:
    """`_span_sums` of one call of fn."""
    with stage_spans(cuda) as spans:
        fn()
    _sync(cuda)
    return _span_sums(spans, cuda)


def _backward_spans(loss, cuda: bool) -> dict:
    """`_span_sums` of the backward of loss() alone: the forward runs inside
    the wrapped stages too, so that a chunk's checkpoint re-runs the wrapped
    recompute, and its calls are left out."""
    with stage_spans(cuda) as spans:
        held = loss()
        forward_calls = {label: len(calls) for label, calls in spans.items()}
        held.backward()
    _sync(cuda)
    return _span_sums(spans, cuda, forward_calls)


def run_profile(res: int = 512, runs: int = 5, device="cuda", chunk: int = 0) -> dict:
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(f"run_profile(device={str(device)!r}): no CUDA device "
                           "here; device='cpu' takes host times only")
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    scene = robot_lens_scene(res=res, device=dev)
    patches, start, direction = scene.patches, scene.start, scene.direction
    target = torch.zeros((128, 128), dtype=torch.float32, device=dev)
    params = lens_model.params_from_scene(scene)
    # step size 0: every step runs on the same lens, so every run is the same work
    step = lens_model.make_train_step(scene.screen_plane, target, learning_rate=0.0,
                                      chunk_size=chunk)

    def forward():
        with torch.no_grad():
            return rd.render_lens_image(patches, scene.refractive_index, start,
                                        direction, scene.screen_plane, resolution=128,
                                        chunk_size=chunk)

    def loss():
        return lens_model.lens_loss(params, start, direction, scene.screen_plane, target,
                                    chunk_size=chunk)

    forward(), step(params, start, direction)          # warm-up (and the build)
    _sync(cuda)
    # the tables (once a trace) and a chunk's inputs on them (the ray pack),
    # profiled first: after a session of a whole 4K step the profiler's
    # short sessions saw no device op in 12 tries (PERF.md §6)
    first = slice(0, chunk or start.shape[0])
    s1, d1 = start[first], direction[first]
    tables = ix.winner_tables(patches)
    tables_busy = _kernels(lambda: ix.winner_tables(patches), cuda)
    rays_busy = _kernels(lambda: cs.prepare_inputs(patches, s1, d1, tables=tables), cuda)

    stages = _stage_means([_run_spans(forward, cuda) for _ in range(runs)], cuda)

    forward_ms = _median_ms(forward, cuda, runs)
    step_ms = _median_ms(lambda: step(params, start, direction), cuda, runs)
    fwd_grad, bwd = [], []
    for _ in range(runs):
        params.zero_grad(set_to_none=True)
        held = {}
        fwd_grad.append(_median_ms(lambda: held.update(loss=loss()), cuda, 1))
        bwd.append(_median_ms(lambda: held["loss"].backward(), cuda, 1))
    bwd_spans = []
    for _ in range(runs):
        params.zero_grad(set_to_none=True)
        bwd_spans.append(_backward_spans(loss, cuda))
    peak_gib = None
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        step(params, start, direction)
        torch.cuda.synchronize()
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30

    inputs = cs.prepare_inputs(patches, s1, d1, tables=tables)
    if cuda:
        counts = cs.launch(inputs).counts
    else:
        counts = cs.tile_bitmap_reference(inputs.bounds, inputs.rays_t).sum(dim=1)
    listed = float(counts.sum()) / (counts.numel() * inputs.bounds.shape[0])
    fwd_busy = _busy(forward, cuda)
    step_busy = _busy(lambda: step(params, start, direction), cuda)
    share = (lambda b, w: b / w if b is not None else None)
    return {
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "rays": int(start.shape[0]), "patches": patches.num_patches, "runs": runs,
        "chunk": chunk,
        "stages_forward": stages,
        "stages_backward": _stage_means(bwd_spans, cuda),
        "forward_ms": forward_ms, "step_ms": step_ms,
        "forward_with_grad_ms": statistics.median(fwd_grad),
        "backward_ms": statistics.median(bwd),
        "step_peak_gib": peak_gib,
        "listed_fraction": listed,
        "forward_profile": {**fwd_busy, "busy_share": share(fwd_busy["busy_ms"], forward_ms)},
        "step_profile": {**step_busy, "busy_share": share(step_busy["busy_ms"], step_ms)},
        "tables_profile": tables_busy,
        "rays_profile": rays_busy,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, default=512, help="ray grid side")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--chunk", type=int, default=0,
                    help="rays a chunk of intersect_rays (0: one chunk)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    records.add_output_args(ap)
    args = ap.parse_args(argv)
    result = run_profile(args.res, args.runs, args.device, args.chunk)
    for label, s in result["stages_forward"].items():
        dev_ms = "not measured" if s["device_ms"] is None else f"{s['device_ms']:.3f} ms"
        print(f"{label:20s} calls {s['calls']}  device {dev_ms}  host {s['host_ms']:.3f} ms")
    record = {"metric": "stage profile of the robot-lens render and train step",
              "command": f"python -m cbtr_tpu_torch.harness.profile_step --res {args.res} "
                         f"--runs {args.runs} --chunk {args.chunk} --device {args.device}",
              **result, **records.card_fields(torch.device(args.device))}
    records.emit(record, args.out, args.label)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cbtr_tpu_torch) on one GPU.

Drives the port's two paths through its hand-written CUDA kernels and
checks them:

* the headline: robot.stl lens, 450 patches, 512x512 collimated rays, 128x128
  image, render and SGD train step (forward + backward), through K1
  (cbtr_tpu_torch/csrc/sweep_select.cu), which culls each tile's blocks
  itself (csrc/block_walk.cuh, shared with K2);
* the large-P lenses above the fused path's 1024 patches, through K2
  (cbtr_tpu_torch/csrc/winner.cu): the refined robot (1800 patches) renders
  and trains at 512^2 rays, the split robots (7200 and 16,200 patches) and the
  dimpled solid (1890) intersect;
* the port's benchmark entry point, `python -m cbtr_tpu_torch.bench`, whose
  staged sweep runs K3 (cbtr_tpu_torch/csrc/sweep_codes.cu, on the same
  block walk at blocks of 32) and whose roofline is measured by K4
  (cbtr_tpu_torch/csrc/fma_peak.cu);
* the table kernel (cbtr_tpu_torch/csrc/tables.cu), which builds K1's, K2's
  and K3's patch table, block bounds and neighbour table at every call of
  theirs: twice a train step.

Phases:

  0  a CUDA device (exit 1 without one), the card, the versions, the build
     of every kernel (one nvcc per source, in parallel) with each kernel's
     registers and spills (ptxas), K1's and K2's CTAs per SM
  1  the headline scene, built by the port's own host stage
  2  K1 against its plain twin at the full shape, the lowest-id tie rule;
     K1's per-tile counts and lists (its in-kernel cull) against the host
     list builder `tile_block_lists`, with and without the AABB leg, and
     its pass-1 pairs against `evaluated_pairs`
  3  the render on K1 and on the plain twin
  4  three SGD train steps (the headline path; launch counts reset before
     it, `tile_block_lists` counted: the GPU path never calls it); the
     loss must fall
  5  timings: CUDA events, median of 7 windows after warm-up; the rays of
     the step's second refraction, K1's lists and time there; both passes'
     evaluated pairs and K1's bound
  6  determinism: the headline gradient twice at one lens (the backward's
     atomics may move its last bits)
  a  refined robot, P = 1800, 512^2: the routing (K2, never K1, above 1024
     patches), K2 against its twin on every ray and its lists against the
     host builder's, the render on K2 and on the twin, three SGD steps (the
     large-P path; counts reset before it, no `tile_block_lists` call),
     forward and fixed-lens step times, both passes' pairs and K2's bound
  b  split-4 robot, P = 7200, 512^2: K2 on the full grid against the twin on
     256 whole tiles spread over it, its lists on the full grid; render time
  c  split-6 robot, P = 16,200, 256^2: K2 against the twin on every ray, its
     lists; intersect time
  d  dimpled solid, P = 1890, 256^2: K2 against the twin on every ray, its
     lists
  e  K1 against K2 on the same inputs at P = 450 (robot 512^2), P = 1020
     (sphere 17 x 10, 256^2) and P = 1800 (K1's twin): the rays on which
     they differ and which one the unculled reference agrees with; both
     kernels' times; at P = 1020 both kernels against their twins and their
     lists against the host builder's
  t  the table kernel against the plain versions (`torch.equal` on the
     patch table, the bounds at block 16 and 32, the neighbours) on the
     robot, refined robot, split-4, split-6, dimpled solid, sphere 17 x 10
     and ellipsoid 15 x 5; its time and the plain versions'; the device ops
     of one `prepare_inputs` (K1, K2, K3) under torch.profiler: under 12
  f  K3 against its twin at 65,536 x 450 (the bench's breakdown shape) and
     65,536 x 1800 (refined): codes on every pair, distances bit-equal on
     every cIntersect pair (the other pairs counted); its in-kernel counts
     and lists against `tile_block_lists(block_p=32)`, with and without the
     AABB leg, its evaluated pairs against `evaluated_pairs`; no
     `tile_block_lists` call inside the wrapper; the staged winners (K3,
     then select_candidates) against K1 or K2; recompute rejects on 4096
     rays; K3's time alone (on outputs filled once), with the output fill,
     with the fill and its tables, and its twin's
  g  K4 against its twin (rtol 2e-6) at the short lengths fp.CHECK_LENGTHS,
     where the chains have not converged, and at both timing lengths;
     the FMA peak measured 3 times (fp.RUNS), every run and the card's ceiling
  h  `python -m cbtr_tpu_torch.bench --preset smoke` in a subprocess: its
     last line parses and holds the headline keys; its launch counts (reset
     at the bench's start, read at its end) show K1, K3 and K4 launched
  i  with --against DIR (the root of another checkout, e.g. an earlier
     commit unpacked by `git archive`): that checkout against this one, each
     in fresh processes, in turns (DIR, this, this, DIR): K1, K2 and K3
     alone, their tables, both together and the host list builder, at
     262,144 x 450 (both refraction passes), 262,144 x 1800, split-4 512^2,
     split-6 256^2 and K3's 65,536 x 450 and x 1800, their winners the same
     in every run; the headline and refined fixed-lens train steps; the
     in-kernel cull alone, on rays turned away from the lens
     (harness/kernel_ab.py)

One line per phase, then the kernel table as JSON, the card's name and
power limit, and last {"ok": true, "device": {...}}.  Any failure raises
and exits non-zero.  Run from the repository root:

    python3 chip_smoke.py [--against DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

# the least time of the card (H100 SXM, NVIDIA's data sheet): f32
# outside the tensor cores, memory
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _time_ms(*args, **kwargs) -> float:
    """`harness/kernel_ab.time_ms`: median over windows of the mean time of
    a few calls (CUDA events)."""
    from cbtr_tpu_torch.harness.kernel_ab import time_ms

    return time_ms(*args, **kwargs)


def _compare(got, ref):
    """Kernel vs twin winners: (any_hit agreement, winner agreement on common
    hits, max |d dist| on common hits, common hits, rays that differ)."""
    import torch

    torch.cuda.synchronize()
    both = got[0] & ref[0]
    differ = (got[0] != ref[0]) | (both & (got[1] != ref[1]))
    hits = int(both.sum())
    return (int((got[0] == ref[0]).sum()) / got[0].numel(),
            int((got[1] == ref[1])[both].sum()) / hits,
            float((got[2] - ref[2])[both].abs().max()),
            hits, int(differ.sum()))


def _assert_exact(name, cmp):
    hit_agree, win_agree, max_abs_err, hits, _ = cmp
    assert hit_agree >= 0.999 and win_agree >= 0.999, (name, cmp)
    # the build (no contraction, IEEE sqrt/div, one shared candidate routine)
    # makes both kernels bit-identical to their twins: hold them to that
    assert hit_agree == 1.0 and win_agree == 1.0 and max_abs_err == 0.0, (name, cmp)
    assert hits > 1000, (name, cmp)


def _train(lens_model, scene, launches_of, learning_rate):
    """Three SGD steps with every launch count reset just before them and
    the host list builder's calls counted: returns (losses, |grad cp| max,
    grad n, {kernel: launches}); fails if the steps called the builder."""
    import torch

    from cbtr_tpu_torch.ops import cuda_sweep as cs

    target = torch.zeros((128, 128), dtype=torch.float32, device=scene.start.device)
    step = lens_model.make_train_step(scene.screen_plane, target, resolution=128,
                                      learning_rate=learning_rate)
    params = lens_model.params_from_scene(scene)
    losses = []
    with _list_builder_calls(cs) as builder_calls:
        for counted in launches_of.values():
            counted.launches = 0
        for _ in range(3):
            params, loss = step(params, scene.start, scene.direction)
            torch.cuda.synchronize()
            g = params.control_points.grad
            assert torch.isfinite(loss) and torch.isfinite(g).all()
            assert float(g.abs().max()) > 0 and torch.isfinite(params.refractive_index.grad)
            losses.append(float(loss))
        launches = {k: v.launches for k, v in launches_of.items()}
    assert builder_calls[0] == 0, builder_calls
    launches["tile_block_lists"] = builder_calls[0]
    assert losses[2] < losses[0], losses
    return losses, float(g.abs().max()), float(params.refractive_index.grad), launches


def _fixed_step_ms(lens_model, scene):
    """Train step at a zero step size, so every timed step runs on the same
    lens (the same work)."""
    import torch

    target = torch.zeros((128, 128), dtype=torch.float32, device=scene.start.device)
    step = lens_model.make_train_step(scene.screen_plane, target, resolution=128,
                                      learning_rate=0.0)
    params = lens_model.params_from_scene(scene)
    return _time_ms(lambda: step(params, scene.start, scene.direction), windows=7, inner=2)


def _flop_per_pair() -> float:
    """The sweep's cost model (pallas_sweep.py:737; bench.py): 1300 FLOP per
    4 Newton iterations + 400."""
    from cbtr_tpu_torch.config import DEFAULT as CFG

    return 1300.0 * CFG.root_search_iterations / 4 + 400.0


def _bound_ms(flops: float, nbytes: float):
    """(bound in ms, "operations" or "bytes"): the larger of the two times."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _winner_bound(inputs, pairs):
    """Bound of one K1/K2 call: its evaluated pairs (pass 1 + retries, counted
    by the kernel) at the cost model, against its tables read once and 8
    bytes a ray written."""
    nbytes = sum(t.numel() * t.element_size() for t in
                 (inputs.rays_t, inputs.patch_t, inputs.bounds, inputs.nb))
    nbytes += 8 * inputs.rays_t.shape[1] + 4 * (inputs.rays_t.shape[1] // 128)
    return _bound_ms(pairs * _flop_per_pair(), nbytes)


def _check_lists(cs, cw, stem, patches, start, direction, use_aabb=True):
    """The kernel's in-kernel cull against the host list builder: per-tile
    counts equal, lists[:counts[t], t] equal; its pass-1 pairs against
    `evaluated_pairs`.  Returns (inputs, listed fraction, pass-1 pairs, retries)."""
    import torch

    prepare = cw.prepare_inputs if stem == "winner" else cs.prepare_inputs
    inputs = prepare(patches, start, direction, use_aabb)
    out = cs.launch_kernel(stem, inputs, lists=True, pairs=True)
    counts, lists = cs.tile_block_lists(patches, inputs.rays_t, use_aabb=use_aabb)
    torch.cuda.synchronize()
    B, T = lists.shape
    assert torch.equal(out.counts, counts), (stem, patches.num_patches)
    mask = torch.arange(B, device=counts.device)[:, None] < counts[None, :]
    assert torch.equal(out.lists[mask], lists[mask]), (stem, patches.num_patches)
    listed = cs.listed_blocks(counts, lists, inputs.patch_t.shape[0])
    P = patches.num_patches
    pass1 = 0
    tiles_per_chunk = max(1, (1 << 27) // (cs.TILE_R * inputs.patch_t.shape[0]))
    for t0 in range(0, T, tiles_per_chunk):
        rt = inputs.rays_t[:, t0 * cs.TILE_R:(t0 + tiles_per_chunk) * cs.TILE_R]
        pass1 += int(cs.evaluated_pairs(listed[t0:t0 + tiles_per_chunk],
                                        cs.sphere_hit_pairs(inputs.patch_t, rt))[:, :P].sum())
    got_pass1, retries = (int(x) for x in out.pairs.sum(dim=0, dtype=torch.int64))
    assert got_pass1 == pass1, (stem, P, got_pass1, pass1)
    return inputs, float(counts.sum()) / (B * T), pass1, retries


def _check_codes_lists(cs, cc, patches, start, direction, use_aabb):
    """K3's in-kernel cull (block 32) against `tile_block_lists`: per-tile
    counts equal, lists[:counts[t], t] equal; its evaluated pairs against
    `evaluated_pairs`.  Returns (inputs, listed fraction, evaluated pairs)."""
    import torch

    inputs = cc.prepare_inputs(patches, start, direction, use_aabb)
    out = cc.launch(inputs, lists=True, pairs=True)
    counts, lists = cs.tile_block_lists(patches, inputs.rays_t, cc.BLOCK_P, use_aabb)
    torch.cuda.synchronize()
    B, T = lists.shape
    P = patches.num_patches
    assert torch.equal(out.counts, counts), ("K3", P, use_aabb)
    mask = torch.arange(B, device=counts.device)[:, None] < counts[None, :]
    assert torch.equal(out.lists[mask], lists[mask]), ("K3", P, use_aabb)
    listed = cs.listed_blocks(counts, lists, inputs.patch_t.shape[0], cc.BLOCK_P)
    executed = int(cs.evaluated_pairs(
        listed, cs.sphere_hit_pairs(inputs.patch_t, inputs.rays_t), cc.BLOCK_P)[:, :P].sum())
    got = int(out.pairs.sum(dtype=torch.int64))
    assert got == executed, ("K3", P, use_aabb, got, executed)
    return inputs, float(counts.sum()) / (B * T), executed


def _check_tables(ct, name, patches):
    """The table kernel against the plain versions on one lens, at block 16
    and 32: every table `torch.equal`.  Returns max |kernel - plain| (0.0)."""
    import torch

    err = 0.0
    for block_p in (16, 32):
        got = ct.build_tables(patches, block_p)
        want = ct.build_tables_reference(patches, block_p)
        torch.cuda.synchronize()
        for table, g, w in zip(("patch_t", "bounds", "nb"), got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, (name, block_p, table)
            assert torch.equal(g, w), (name, block_p, table, int((g != w).sum()))
            # empty blocks hold infinite box corners on both sides: inf - inf
            err = max(err, float((g.double() - w.double()).abs().nan_to_num(0.0).max()))
    return err


@contextlib.contextmanager
def _list_builder_calls(cs):
    """Counts the calls of `cuda_sweep.tile_block_lists` inside the block
    (every caller reaches it through the module)."""
    calls = [0]
    builder = cs.tile_block_lists

    def counted(*args, **kwargs):
        calls[0] += 1
        return builder(*args, **kwargs)

    cs.tile_block_lists = counted
    try:
        yield calls
    finally:
        cs.tile_block_lists = builder


def _list_ms(cs, patches, start, direction) -> float:
    """Time of the host list builder alone (plain torch; the lists K1 and K2
    took before they culled for themselves, and the twins' and K3's)."""
    rays_t = cs.pad_rays(start, direction)
    return _time_ms(lambda: cs.tile_block_lists(patches, rays_t), windows=5)


def _sides_with(cs, patches, start, direction, k1, k2):
    """On the rays where K1's and K2's winners differ: how many the unculled
    reference (every pair evaluated) agrees with, for each kernel."""
    full = cs.sweep_select_reference(patches, start, direction, cull=False)
    differ = (k1[0] != k2[0]) | (k1[0] & k2[0] & (k1[1] != k2[1]))

    def agrees(w):
        return (w[0] == full[0]) & (~full[0] | (w[1] == full[1]))

    return (int(differ.sum()), int((differ & agrees(k1)).sum()),
            int((differ & agrees(k2)).sum()))


def _render(scene, backend="auto"):
    import torch

    from cbtr_tpu_torch.render.render import render_lens_image

    with torch.no_grad():
        return render_lens_image(scene.patches, scene.refractive_index, scene.start,
                                 scene.direction, scene.screen_plane, resolution=128,
                                 backend=backend)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", default="", help="root of another checkout to "
                    "time this one against (phase i)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's GPU path cannot run here",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cbtr_tpu_torch.models import (
        dimpled_lens_scene,
        ellipsoid_lens_scene,
        lens_model,
        robot_lens_scene,
        sphere_lens_scene,
    )
    from cbtr_tpu_torch.benchmarks import fma_peak as fp
    from cbtr_tpu_torch.harness import kernel_ab
    from cbtr_tpu_torch.harness.profile_step import _busy
    from cbtr_tpu_torch.ops import cuda_codes as cc
    from cbtr_tpu_torch.ops import cuda_sweep as cs
    from cbtr_tpu_torch.ops import cuda_tables as ct
    from cbtr_tpu_torch.ops import cuda_winner as cw
    from cbtr_tpu_torch.ops import intersect as ix

    # the splat is an f32 matrix product: TF32 would change the image
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = _card()
    kernels = {"sweep_select": cs.sweep_select, "winner": cw.sweep_winner,
               "sweep_codes": cc.sweep_codes_cuda, "fma_chains": fp.fma_chains,
               "tables": ct.build_tables}
    table_lenses = {}       # name -> patches, for phase t
    t_script = time.perf_counter()

    # ---- 0: device, versions, kernel build -------------------------------
    t = time.perf_counter()
    build_log = cs.build_library()
    build_s = time.perf_counter() - t
    print(f"[0] card: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| python {sys.version.split()[0]} | K1 + K2 + K3 + K4 + tables build (one nvcc "
          f"per source, in parallel) {build_s:.3f} s",
          flush=True)
    for line in build_log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            print(f"[0] ptxas {line.strip()}", flush=True)
    print(f"[0] CTAs per SM: K1 {cs.occupancy('sweep_select', 512)} (P_pad 512), K2 "
          f"{cs.occupancy('winner', 1920)} (P_pad 1920), "
          f"{cs.occupancy('winner', 16256)} (P_pad 16,256)", flush=True)

    # ---- 1: scene ----------------------------------------------------------
    t = time.perf_counter()
    scene = robot_lens_scene(res=512, device=dev)
    P, R = scene.patches.num_patches, scene.start.shape[0]
    assert (P, R) == (450, 262144), (P, R)
    print(f"[1] scene: robot.stl lens, P = {P} patches, R = {R} rays "
          f"(built in {time.perf_counter() - t:.3f} s)", flush=True)
    patches, start, direction = scene.patches, scene.start, scene.direction
    table_lenses["robot"] = patches

    # ---- 2: K1 against its plain twin ------------------------------------
    got = cs.sweep_select(patches, start, direction)
    ref = cs.sweep_select_reference(patches, start, direction)
    k1_cmp = _compare(got, ref)
    _, rejects = ix.recompute_winner(patches, start, direction, got[0], got[1],
                                     with_check=True)
    print(f"[2] K1 vs twin at {R} x {P}: any_hit agreement {k1_cmp[0]:.6f}, "
          f"win agreement on {k1_cmp[3]} common hits {k1_cmp[1]:.6f}, "
          f"max |d dist| {k1_cmp[2]:.3e}, recompute rejects {rejects}", flush=True)
    _assert_exact("K1", k1_cmp)
    assert k1_cmp[3] > 10000 and rejects == 0
    for use_aabb in (True, False):
        _, frac, pass1, retries = _check_lists(cs, cw, "sweep_select", patches, start,
                                               direction, use_aabb)
        print(f"[2] K1's in-kernel cull at {R} x {P}, use_aabb={use_aabb}: counts and "
              f"lists equal tile_block_lists', {frac:.4f} of tile x block pairs listed; "
              f"pass-1 pairs {pass1} (= evaluated_pairs), retries {retries}", flush=True)

    # tie rule: a copy of a hit patch prepended as patch 0 ties it exactly
    both = got[0] & ref[0]
    w = int(got[1][both][0])
    ray = int(torch.nonzero(both & (got[1] == w))[0])
    leaves = {k: torch.cat([v[w:w + 1], v]) for k, v in patches.leaves().items()}
    leaves["neighbours"] = leaves["neighbours"] + 1
    tied = type(patches)(**leaves)
    t_hit, t_win, _ = cs.sweep_select(tied, start[ray:ray + 2], direction[ray:ray + 2])
    k2_hit, k2_win, _ = cw.sweep_winner(tied, start[ray:ray + 2], direction[ray:ray + 2])
    assert bool(t_hit[0]) and int(t_win[0]) == 0, (t_hit, t_win)
    assert bool(k2_hit[0]) and int(k2_win[0]) == 0, (k2_hit, k2_win)
    print(f"[2] tie: ray {ray} on patch {w} and its copy -> K1 win {int(t_win[0])}, "
          f"K2 win {int(k2_win[0])}", flush=True)

    # ---- 3: render on K1 and on the plain twin ---------------------------
    before = cs.sweep_select.launches
    img = _render(scene)
    launched = cs.sweep_select.launches - before
    img_plain = _render(scene, backend="plain")
    torch.cuda.synchronize()
    assert launched == 2, launched
    assert torch.isfinite(img).all() and torch.isfinite(img_plain).all()
    assert float(img.sum()) > 1000.0
    torch.testing.assert_close(img, img_plain, rtol=1e-3, atol=1e-4)
    print(f"[3] render 512^2 rays -> 128^2 image: sum {float(img.sum()):.3f}, "
          f"max |K1 - plain| {float((img - img_plain).abs().max()):.3e}, "
          f"K1 launches {launched}", flush=True)

    # ---- 4: the headline path: three SGD steps ---------------------------
    # The loss scales with the square of the rays per pixel, so the step size
    # is the one that descends at 64^2 rays (1e-3) scaled by (64/512)^4.
    losses, g_max, g_n, main_launches = _train(lens_model, scene, kernels, 2.5e-7)
    assert main_launches == {"sweep_select": 6, "winner": 0, "sweep_codes": 0,
                             "fma_chains": 0, "tables": 6,
                             "tile_block_lists": 0}, main_launches
    print(f"[4] train: 3 SGD steps, loss {losses}, |grad cp| max {g_max:.4e}, "
          f"grad n {g_n:.4e}, launches {main_launches}", flush=True)

    # ---- 5: timings --------------------------------------------------------
    inputs, listed, pass1, retries = _check_lists(cs, cw, "sweep_select", patches,
                                                  start, direction)
    k1_bound = _winner_bound(inputs, pass1 + retries)
    k1_launch_ms = _time_ms(lambda: cs.launch(inputs))
    k1_ms = _time_ms(lambda: cs.sweep_select(patches, start, direction))
    k1_plain_ms = _time_ms(lambda: cs.sweep_select_reference(patches, start, direction),
                           windows=3, inner=1, warmup=1)
    render_ms = _time_ms(lambda: _render(scene))
    step_ms = _fixed_step_ms(lens_model, scene)
    print(f"[5] {card} | K1 sweep+select {R} x {P}: {k1_ms:.3f} ms with its "
          f"tables ({k1_launch_ms:.3f} ms kernel alone, {listed:.4f} of tile x block "
          f"pairs listed) vs plain twin {k1_plain_ms:.3f} ms; evaluated pairs "
          f"{pass1} + {retries} retries, bound {k1_bound[0]:.4f} ms ({k1_bound[1]})",
          flush=True)
    s2, d2 = kernel_ab.second_pass_rays(scene)
    in2, listed2, pass1_2, retries_2 = _check_lists(cs, cw, "sweep_select", patches, s2, d2)
    k1_bound_2 = _winner_bound(in2, pass1_2 + retries_2)
    k1_2_launch_ms = _time_ms(lambda: cs.launch(in2))
    k1_2_ms = _time_ms(lambda: cs.sweep_select(patches, s2, d2))
    print(f"[5] {card} | K1 on the step's second refraction ({s2.shape[0]} rays): "
          f"{k1_2_ms:.3f} ms with its tables ({k1_2_launch_ms:.3f} ms kernel alone, "
          f"{listed2:.4f} listed; lists equal tile_block_lists'); evaluated pairs "
          f"{pass1_2} + {retries_2} retries, bound {k1_bound_2[0]:.4f} ms; both passes "
          f"{(pass1 + retries + pass1_2 + retries_2) / (2 * R * P):.4f} of R x P", flush=True)
    del in2
    print(f"[5] {card} | forward render {R} rays: {render_ms:.3f} ms "
          f"({R / render_ms * 1e3:.1f} rays/s)", flush=True)
    print(f"[5] {card} | train step fwd+bwd+SGD {R} rays: {step_ms:.3f} ms "
          f"({R / step_ms * 1e3:.1f} rays/s fwd+bwd)", flush=True)

    # ---- 6: determinism of the headline gradient ----------------------------
    target = torch.zeros((128, 128), dtype=torch.float32, device=dev)
    params = lens_model.params_from_scene(scene)
    grads = []
    for _ in range(2):
        params.zero_grad(set_to_none=True)
        lens_model.lens_loss(params, start, direction, scene.screen_plane, target,
                             resolution=128).backward()
        grads.append((params.control_points.grad.clone(),
                      params.refractive_index.grad.clone()))
    d_cp = float((grads[0][0] - grads[1][0]).abs().max())
    d_n = float((grads[0][1] - grads[1][1]).abs())
    g_max = float(grads[0][0].abs().max())
    print(f"[6] the headline gradient twice at one lens: max |d grad cp| {d_cp:.3e}, "
          f"|d grad n| {d_n:.3e} (|grad cp| max {g_max:.4e})", flush=True)
    # the recompute's row gather accumulates its backward with atomics on the
    # GPU: the order moves the last bits, nothing more
    assert d_cp <= 1e-5 * g_max and d_n <= 1e-5 * abs(float(grads[0][1])), (d_cp, d_n)

    # ---- a: refined robot, P = 1800: the large-P path on K2 ---------------
    t = time.perf_counter()
    refined = robot_lens_scene(res=512, refine=True, device=dev)
    rp, rs, rd = refined.patches, refined.start, refined.direction
    assert (rp.num_patches, rs.shape[0]) == (1800, 262144), rp.num_patches
    host_s = time.perf_counter() - t
    table_lenses["refined"] = rp
    for counted in kernels.values():
        counted.launches = 0
    ix.intersect_rays(rp, rs[:4096], rd[:4096])
    routed = {k: v.launches for k, v in kernels.items()}
    assert routed == {"sweep_select": 0, "winner": 1, "sweep_codes": 0,
                      "fma_chains": 0, "tables": 1}, routed
    got = cw.sweep_winner(rp, rs, rd)
    ref = cw.sweep_winner_reference(rp, rs, rd)
    k2_cmp = _compare(got, ref)
    _, rejects = ix.recompute_winner(rp, rs, rd, got[0], got[1], with_check=True)
    print(f"[a] refined robot: P = {rp.num_patches}, R = {rs.shape[0]} (host build "
          f"{host_s:.3f} s); intersect_rays launches {routed}; K2 vs twin: any_hit "
          f"agreement {k2_cmp[0]:.6f}, win agreement on {k2_cmp[3]} common hits "
          f"{k2_cmp[1]:.6f}, max |d dist| {k2_cmp[2]:.3e}, recompute rejects {rejects}",
          flush=True)
    _assert_exact("K2 refined", k2_cmp)
    assert rejects == 0
    k2_inputs, listed, k2_pass1, k2_retries = _check_lists(cs, cw, "winner", rp, rs, rd)
    k2_bound = _winner_bound(k2_inputs, k2_pass1 + k2_retries)
    img = _render(refined)
    img_plain = _render(refined, backend="plain")
    torch.cuda.synchronize()
    assert torch.isfinite(img).all() and float(img.sum()) > 1000.0
    torch.testing.assert_close(img, img_plain, rtol=1e-3, atol=1e-4)
    losses, g_max, g_n, large_launches = _train(lens_model, refined, kernels, 2.5e-7)
    assert large_launches == {"sweep_select": 0, "winner": 6, "sweep_codes": 0,
                              "fma_chains": 0, "tables": 6,
                              "tile_block_lists": 0}, large_launches
    print(f"[a] render on K2 vs twin: max |d| {float((img - img_plain).abs().max()):.3e}; "
          f"train: 3 SGD steps, loss {losses}, |grad cp| max {g_max:.4e}, grad n "
          f"{g_n:.4e}, launches {large_launches}", flush=True)
    k2_launch_ms = _time_ms(lambda: cw.launch(k2_inputs))
    k2_ms = _time_ms(lambda: cw.sweep_winner(rp, rs, rd))
    k2_plain_ms = _time_ms(lambda: cw.sweep_winner_reference(rp, rs, rd),
                           windows=1, inner=1, warmup=0)
    r_list_ms = _list_ms(cs, rp, rs, rd)
    r_render_ms = _time_ms(lambda: _render(refined))
    r_step_ms = _fixed_step_ms(lens_model, refined)
    print(f"[a] {card} | K2 winner {rs.shape[0]} x {rp.num_patches}: {k2_ms:.3f} ms "
          f"with its tables ({k2_launch_ms:.3f} ms kernel alone, host list builder "
          f"{r_list_ms:.3f} ms, {listed:.4f} of tile x block pairs listed; lists equal "
          f"tile_block_lists') vs plain twin {k2_plain_ms:.3f} ms; evaluated pairs "
          f"{k2_pass1} + {k2_retries} retries, bound {k2_bound[0]:.4f} ms", flush=True)
    rs2, rd2 = kernel_ab.second_pass_rays(refined)
    _, _, pass1_2, retries_2 = _check_lists(cs, cw, "winner", rp, rs2, rd2)
    print(f"[a] {card} | K2 on the refined step's second refraction: evaluated pairs "
          f"{pass1_2} + {retries_2} retries (lists equal tile_block_lists'); both "
          f"passes {(k2_pass1 + k2_retries + pass1_2 + retries_2) / (2 * 262144 * 1800):.4f}"
          f" of R x P", flush=True)
    del rs2, rd2
    print(f"[a] {card} | refined forward render {rs.shape[0]} rays: {r_render_ms:.3f} "
          f"ms ({rs.shape[0] / r_render_ms * 1e3:.1f} rays/s); train step fwd+bwd+SGD: "
          f"{r_step_ms:.3f} ms ({rs.shape[0] / r_step_ms * 1e3:.1f} rays/s fwd+bwd)",
          flush=True)
    del k2_inputs, img, img_plain

    # ---- b: split-4 robot, P = 7200, 512^2 ----------------------------------
    split4 = robot_lens_scene(res=512, split=4, device=dev)
    sp, ss, sd = split4.patches, split4.start, split4.direction
    assert sp.num_patches == 7200, sp.num_patches
    table_lenses["split-4"] = sp
    got = cw.sweep_winner(sp, ss, sd)
    tiles = torch.arange(0, ss.shape[0] // cs.TILE_R, 8, device=dev)[:256]
    rays = (tiles[:, None] * cs.TILE_R + torch.arange(cs.TILE_R, device=dev)).reshape(-1)
    ref = cw.sweep_winner_reference(sp, ss[rays], sd[rays])
    cmp = _compare(tuple(x[rays] for x in got), ref)
    _assert_exact("K2 split-4", cmp)
    _, s4_listed, s4_pairs, _ = _check_lists(cs, cw, "winner", sp, ss, sd)
    s4_ms = _time_ms(lambda: cw.sweep_winner(sp, ss, sd))
    s4_list_ms = _list_ms(cs, sp, ss, sd)
    s4_render_ms = _time_ms(lambda: _render(split4), windows=5)
    print(f"[b] {card} | split-4 robot: P = {sp.num_patches}, R = {ss.shape[0]}; K2 vs "
          f"twin on {tiles.numel()} whole tiles ({rays.numel()} rays): any_hit agreement "
          f"{cmp[0]:.6f}, win agreement on {cmp[3]} common hits {cmp[1]:.6f}, max |d "
          f"dist| {cmp[2]:.3e}; lists on the full grid equal tile_block_lists' "
          f"({s4_listed:.4f} listed, {s4_pairs} pass-1 pairs); K2 with tables "
          f"{s4_ms:.3f} ms (host list builder {s4_list_ms:.3f} ms); forward render "
          f"{s4_render_ms:.3f} ms ({ss.shape[0] / s4_render_ms * 1e3:.1f} rays/s)",
          flush=True)
    del split4, sp, ss, sd, got, ref

    # ---- c: split-6 robot, P = 16,200, 256^2 --------------------------------
    split6 = robot_lens_scene(res=256, split=6, device=dev)
    sp, ss, sd = split6.patches, split6.start, split6.direction
    assert sp.num_patches == 16200, sp.num_patches
    table_lenses["split-6"] = sp
    cmp = _compare(cw.sweep_winner(sp, ss, sd), cw.sweep_winner_reference(sp, ss, sd))
    _assert_exact("K2 split-6", cmp)
    _, s6_listed, s6_pairs, _ = _check_lists(cs, cw, "winner", sp, ss, sd)
    s6_ms = _time_ms(lambda: cw.sweep_winner(sp, ss, sd))
    s6_list_ms = _list_ms(cs, sp, ss, sd)
    s6_ix_ms = _time_ms(lambda: ix.intersect_rays(sp, ss, sd))
    print(f"[c] {card} | split-6 robot: P = {sp.num_patches}, R = {ss.shape[0]}; K2 vs "
          f"twin: any_hit agreement {cmp[0]:.6f}, win agreement on {cmp[3]} common hits "
          f"{cmp[1]:.6f}, max |d dist| {cmp[2]:.3e}; lists equal tile_block_lists' "
          f"({s6_listed:.4f} listed, {s6_pairs} pass-1 pairs); K2 with tables "
          f"{s6_ms:.3f} ms (host list builder {s6_list_ms:.3f} ms); "
          f"intersect_rays {s6_ix_ms:.3f} ms ({ss.shape[0] / s6_ix_ms * 1e3:.1f} rays/s)",
          flush=True)
    del split6, sp, ss, sd

    # ---- d: dimpled solid, P = 1890, 256^2 -----------------------------------
    dimpled = dimpled_lens_scene(res=256, device=dev)
    dp, ds, dd = dimpled.patches, dimpled.start, dimpled.direction
    assert dp.num_patches == 1890, dp.num_patches
    table_lenses["dimpled"] = dp
    cmp = _compare(cw.sweep_winner(dp, ds, dd), cw.sweep_winner_reference(dp, ds, dd))
    _assert_exact("K2 dimpled", cmp)
    _check_lists(cs, cw, "winner", dp, ds, dd)
    print(f"[d] dimpled solid: P = {dp.num_patches}, R = {ds.shape[0]}; K2 vs twin: "
          f"any_hit agreement {cmp[0]:.6f}, win agreement on {cmp[3]} common hits "
          f"{cmp[1]:.6f}, max |d dist| {cmp[2]:.3e}; lists equal tile_block_lists'",
          flush=True)

    # ---- e: K1 against K2 on the same inputs ---------------------------------
    # Their retry rules differ (K2 gates a voted neighbour by its own sphere,
    # K1 by its block's evaluation): count the rays they split and which
    # side the unculled reference takes.  K1 cannot launch above 1024
    # patches, so at P = 1800 its twin stands in.
    sphere = sphere_lens_scene(res=256, sectors=17, belts=10, device=dev)
    table_lenses["sphere 17x10"] = sphere.patches
    for name, sc in (("robot", scene), ("sphere 17x10", sphere), ("refined", refined)):
        p, s, d = sc.patches, sc.start, sc.direction
        k1_of = cs.sweep_select if p.num_patches <= cs._FUSED_MAX_P \
            else cs.sweep_select_reference
        k1, k2 = k1_of(p, s, d), cw.sweep_winner(p, s, d)
        cmp = _compare(k1, k2)
        assert cmp[0] >= 0.999 and cmp[1] >= 0.999, (name, cmp)
        differ, with_k1, with_k2 = _sides_with(cs, p, s, d, k1, k2)
        line = (f"[e] {card} | {name}: P = {p.num_patches}, R = {s.shape[0]}; K1 vs K2: "
                f"any_hit agreement {cmp[0]:.6f}, win agreement {cmp[1]:.6f}, {differ} "
                f"rays differ, of which the unculled reference agrees with K1 on "
                f"{with_k1}, with K2 on {with_k2}")
        if name == "sphere 17x10":
            # K1 and K2 at K1's largest table: each against its twin, lists
            _assert_exact("K1 sphere", _compare(k1, cs.sweep_select_reference(p, s, d)))
            _assert_exact("K2 sphere", _compare(k2, cw.sweep_winner_reference(p, s, d)))
            for stem in ("sweep_select", "winner"):
                _check_lists(cs, cw, stem, p, s, d)
            line += "; both bit-equal to their twins, lists equal tile_block_lists'"
        if k1_of is cs.sweep_select:
            i1, i2 = cs.prepare_inputs(p, s, d), cw.prepare_inputs(p, s, d)
            line += (f"; kernel alone K1 {_time_ms(lambda: cs.launch(i1)):.3f} ms, "
                     f"K2 {_time_ms(lambda: cw.launch(i2)):.3f} ms")
        else:
            line += " (K1's twin)"
        print(line, flush=True)
    del sphere

    # ---- t: the table kernel against the plain versions --------------------------
    table_lenses["ellipsoid 15x5"] = ellipsoid_lens_scene(res=16, device=dev).patches
    assert len(table_lenses) == 7, sorted(table_lenses)
    before = ct.build_tables.launches
    tables_err = max(_check_tables(ct, name, lens) for name, lens in table_lenses.items())
    assert ct.build_tables.launches - before == 14
    print(f"[t] table kernel vs plain versions (patch table, bounds at block 16 and 32, "
          f"neighbours): torch.equal on "
          f"{', '.join(f'{n} (P = {q.num_patches})' for n, q in table_lenses.items())}",
          flush=True)
    tables_ms, tables_plain_ms = {}, {}
    for name in ("robot", "refined", "split-6"):
        lens = table_lenses[name]
        tables_ms[name] = _time_ms(lambda: ct.build_tables(lens, cs.BLOCK_P))
        tables_plain_ms[name] = _time_ms(lambda: ct.build_tables_reference(lens, cs.BLOCK_P))
    # inputs read once (60 floats and 3 ids a patch), outputs written once;
    # about 190 operations a patch (27 adds, 3 divisions, 10 norms of 9, 60
    # min/max) and 13 a patch again in its block
    tables_out = ct.build_tables(patches, cs.BLOCK_P)
    tables_bound = _bound_ms(
        203.0 * P, sum(x.numel() * x.element_size()
                       for x in (*patches.leaves().values(), *tables_out)))
    prepare_ops = {
        "K1": _busy(lambda: cs.prepare_inputs(patches, start, direction), True),
        "K2": _busy(lambda: cw.prepare_inputs(rp, rs, rd), True),
        "K3": _busy(lambda: cc.prepare_inputs(patches, start[:65536], direction[:65536]), True)}
    prepare_ms = _time_ms(lambda: cs.prepare_inputs(patches, start, direction))
    print(f"[t] {card} | table kernel at block 16: "
          f"{', '.join(f'{n} {tables_ms[n]:.4f} ms (plain versions {tables_plain_ms[n]:.3f} ms)' for n in tables_ms)}"
          f"; bound {tables_bound[0]:.6f} ms ({tables_bound[1]}); prepare_inputs "
          f"{R} x {P} {prepare_ms:.4f} ms; device ops of one prepare_inputs: "
          f"{ {k: v['device_ops'] for k, v in prepare_ops.items()} }", flush=True)
    assert all(0 < v["device_ops"] < 12 for v in prepare_ops.values()), prepare_ops
    del tables_out, table_lenses

    # ---- f: K3 against its twin; the staged winners ----------------------------
    k3_rows = {}
    for name, sc in (("robot", scene), ("refined", refined)):
        p, s, d = sc.patches, sc.start[:65536], sc.direction[:65536]
        with _list_builder_calls(cs) as list_calls:
            code, dist = cc.sweep_codes_cuda(p, s, d)
        assert list_calls[0] == 0, list_calls
        code_r, dist_r = cc.sweep_codes_reference(p, s, d)
        torch.cuda.synchronize()
        inter = (code_r & 7) == ix.WHAT_INTERSECT
        codes_differ = int((code != code_r).sum())
        dist_differ = int((dist != dist_r)[inter].sum())
        other_differ = int((dist != dist_r)[~inter].sum())
        max_err = float((dist - dist_r)[inter].abs().max())
        staged = ix.select_candidates(code, dist, p.neighbours)
        direct = (cs.sweep_select if p.num_patches <= cs._FUSED_MAX_P else cw.sweep_winner)
        cmp = _compare(staged, direct(p, s, d))
        _, rejects = ix.recompute_winner(p, s[:4096], d[:4096], staged[0][:4096],
                                         staged[1][:4096], with_check=True)
        print(f"[f] K3 vs twin at {s.shape[0]} x {p.num_patches} ({name}): pairs with "
              f"another code {codes_differ} of {code.numel()}, cIntersect pairs "
              f"{int(inter.sum())} of which with another distance {dist_differ} (max "
              f"|d| {max_err:.3e}), other pairs with another distance {other_differ}; "
              f"staged winners vs {direct.__name__}: any_hit agreement {cmp[0]:.6f}, win "
              f"agreement {cmp[1]:.6f}, {cmp[4]} rays differ; recompute rejects on 4096 "
              f"rays {rejects}", flush=True)
        assert codes_differ == 0 and dist_differ == 0 and int(inter.sum()) > 10000, name
        assert cmp[0] >= 0.999 and cmp[1] >= 0.999 and rejects <= 4, (name, cmp, rejects)
        del code, dist, code_r, dist_r, inter, staged
        _, sphere_listed, sphere_pairs = _check_codes_lists(cs, cc, p, s, d, False)
        k3_in, listed, executed = _check_codes_lists(cs, cc, p, s, d, True)
        print(f"[f] K3's in-kernel cull at {s.shape[0]} x {p.num_patches} (block "
              f"{cc.BLOCK_P}): counts and lists equal tile_block_lists', {listed:.4f} of "
              f"tile x block pairs listed and {executed} pairs evaluated (= "
              f"evaluated_pairs) with the AABB leg, {sphere_listed:.4f} and {sphere_pairs} "
              f"without; tile_block_lists calls inside sweep_codes_cuda "
              f"{list_calls[0]}", flush=True)
        k3_out = cc.filled_outputs(k3_in)
        k3_rows[name] = dict(
            max_err=max_err,
            bound=_bound_ms(executed * _flop_per_pair(),
                            sum(x.numel() * x.element_size() for x in
                                (k3_in.rays_t, k3_in.patch_t, k3_in.bounds, *k3_out))
                            + 4 * k3_in.rays_t.shape[1] // cs.TILE_R),
            alone=_time_ms(lambda: cc.launch(k3_in, k3_out)),
            fill=_time_ms(lambda: cc.launch(k3_in)),
            tables=_time_ms(lambda: cc.sweep_codes_cuda(p, s, d)),
            plain=_time_ms(lambda: cc.sweep_codes_reference(p, s, d), windows=1, inner=1,
                           warmup=0))
        del k3_in, k3_out
        torch.cuda.empty_cache()
        print(f"[f] {card} | K3 sweep codes {s.shape[0]} x {p.num_patches}: "
              f"{k3_rows[name]['alone']:.3f} ms kernel alone (outputs filled once), "
              f"{k3_rows[name]['fill']:.3f} ms with the output fill, "
              f"{k3_rows[name]['tables']:.3f} ms with the fill and its tables vs plain "
              f"twin {k3_rows[name]['plain']:.3f} ms; evaluated pairs {executed}, bound "
              f"{k3_rows[name]['bound'][0]:.4f} ms ({k3_rows[name]['bound'][1]})", flush=True)

    # ---- g: K4 against its twin; the FMA peak ------------------------------------
    a = 0.5 + 0.2 * torch.rand(fp.chains_elements(dev), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
    # the timing lengths only show the chains' fixed point; the short ones
    # (fp.CHECK_LENGTHS) hold the start factors, the step count and the
    # unroll remainder
    k4_err, rels = 0.0, {}
    for n_iter in (*fp.CHECK_LENGTHS, fp.N_SMALL, fp.N_BIG):
        got, ref = fp.launch(a, n_iter), fp.fma_chains_reference(a, n_iter)
        torch.cuda.synchronize()
        rels[n_iter] = float(((got - ref).abs() / ref.abs()).max())
        k4_err = max(k4_err, float((got - ref).abs().max()))
        assert torch.isfinite(got).all() and rels[n_iter] <= 2e-6, (n_iter, rels)
    print(f"[g] K4 vs twin, {a.numel()} elements x {fp.K_CHAINS} chains: max relative "
          f"difference by steps {', '.join(f'{n}: {r:.3e}' for n, r in rels.items())}",
          flush=True)
    k4_ms = {n: _time_ms(lambda n=n: fp.launch(a, n), windows=5, inner=1)
             for n in (fp.N_SMALL, fp.N_BIG)}
    k4_plain_ms = _time_ms(lambda: fp.fma_chains_reference(a, fp.N_BIG), windows=1,
                           inner=1, warmup=0)
    runs = [fp.measure_fma_peak(5, dev) for _ in range(fp.RUNS)]
    ceiling = fp.fma_ceiling(dev)
    peak, kept = fp.select_peak(runs, ceiling)
    print(f"[g] {card} | K4 {fp.N_SMALL} steps {k4_ms[fp.N_SMALL]:.3f} ms, {fp.N_BIG} "
          f"steps {k4_ms[fp.N_BIG]:.3f} ms (plain twin {k4_plain_ms:.3f} ms); FMA peak "
          f"runs {[round(r / 1e12, 3) for r in runs]} TFLOP/s, ceiling "
          f"{ceiling / 1e12:.3f} TFLOP/s, reported {peak / 1e12:.3f} ({len(kept)} runs "
          f"kept)", flush=True)
    assert k4_ms[fp.N_BIG] >= 5.0 and k4_ms[fp.N_SMALL] <= k4_ms[fp.N_BIG] / 10, k4_ms
    assert 0 < peak <= ceiling
    k4_bound = _bound_ms(2.0 * fp.K_CHAINS * a.numel() * fp.N_BIG, 8.0 * a.numel())

    # ---- h: the bench entry point -----------------------------------------------
    torch.cuda.empty_cache()
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "cbtr_tpu_torch.bench", "--preset",
                           "smoke"], capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    bench = json.loads(proc.stdout.strip().splitlines()[-1])
    for key in ("metric", "value", "unit", "vs_baseline", "fma_peak_tflops"):
        assert key in bench, key
    assert bench["value"] > 0 and bench["breakdown_ms"]["sweep_staged"] > 0
    bench_launches = bench["kernel_launches"]
    assert all(bench_launches[k] > 0 for k in ("sweep_select", "sweep_codes",
                                                "fma_chains")), bench_launches
    print(f"[h] bench --preset smoke in {time.perf_counter() - t:.1f} s: "
          f"{bench['metric']}: "
          f"{bench['value']} {bench['unit']}, vs_baseline {bench['vs_baseline']}, staged "
          f"sweep {bench['breakdown_ms']['sweep_staged']} ms, FMA peak "
          f"{bench['fma_peak_tflops']} TFLOP/s, launches {bench_launches}", flush=True)

    # ---- i: another checkout against this one ------------------------------------
    if args.against:
        torch.cuda.empty_cache()
        for row in kernel_ab.compare_checkouts(args.against):
            print(f"[i] {card} | {json.dumps(row)}", flush=True)
            assert row.get("same_winners", True), row
        for row in kernel_ab.cull_rows(dev):
            print(f"[i] {card} | {json.dumps(row)}", flush=True)
    else:
        print("[i] no --against DIR: the comparison with another checkout is not run",
              flush=True)

    print(f"chip_smoke took {time.perf_counter() - t_script:.1f} s after the imports",
          flush=True)
    print(json.dumps({"kernels": [
        {
            "name": "sweep_select",
            "route": "cuda",
            "source": "cbtr_tpu_torch/csrc/sweep_select.cu",
            "replaces": "cbtr_tpu/ops/pallas_sweep.py:634",
            "launches": main_launches["sweep_select"],
            "launches_per_step": main_launches["sweep_select"] / 3,
            "max_abs_err": k1_cmp[2],
            "ms": k1_ms,
            "plain_ms": k1_plain_ms,
            "bound_ms": k1_bound[0],
            "bound_by": k1_bound[1],
            "library_ms": None,
            "kernel_only_ms": k1_launch_ms,
            "second_pass_ms": k1_2_ms,
            "second_pass_bound_ms": k1_bound_2[0],
        },
        {
            "name": "winner",
            "route": "cuda",
            "source": "cbtr_tpu_torch/csrc/winner.cu",
            "replaces": "cbtr_tpu/ops/pallas_sweep.py:1017",
            "launches": large_launches["winner"],
            "launches_per_step": large_launches["winner"] / 3,
            "max_abs_err": k2_cmp[2],
            "ms": k2_ms,
            "plain_ms": k2_plain_ms,
            "bound_ms": k2_bound[0],
            "bound_by": k2_bound[1],
            "library_ms": None,
            "kernel_only_ms": k2_launch_ms,
        },
        {
            "name": "sweep_codes",
            "route": "cuda",
            "source": "cbtr_tpu_torch/csrc/sweep_codes.cu",
            "replaces": "cbtr_tpu/ops/pallas_sweep.py:125",
            "launches": bench_launches["sweep_codes"],
            "launches_per_step": 0,
            "max_abs_err": max(r["max_err"] for r in k3_rows.values()),
            "ms": k3_rows["robot"]["tables"],
            "plain_ms": k3_rows["robot"]["plain"],
            "bound_ms": k3_rows["robot"]["bound"][0],
            "bound_by": k3_rows["robot"]["bound"][1],
            "library_ms": None,
            "kernel_only_ms": k3_rows["robot"]["alone"],
            "kernel_and_fill_ms": k3_rows["robot"]["fill"],
        },
        {
            "name": "tables",
            "route": "cuda",
            "source": "cbtr_tpu_torch/csrc/tables.cu",
            "replaces": "cbtr_tpu/ops/pallas_sweep.py:598 pack_patch_table, :547 "
                        "_block_spheres_cr, :502 _patch_boxes (XLA functions, no "
                        "Pallas kernel)",
            "launches": main_launches["tables"],
            "launches_per_step": main_launches["tables"] / 3,
            "max_abs_err": tables_err,
            "ms": tables_ms["robot"],
            "plain_ms": tables_plain_ms["robot"],
            "bound_ms": tables_bound[0],
            "bound_by": tables_bound[1],
            "library_ms": None,
            "prepare_inputs_ms": prepare_ms,
            "prepare_inputs_device_ops": prepare_ops["K1"]["device_ops"],
        },
        {
            "name": "fma_chains",
            "route": "cuda",
            "source": "cbtr_tpu_torch/csrc/fma_peak.cu",
            "replaces": "benchmarks/vpu_peak.py:48",
            "launches": bench_launches["fma_chains"],
            "launches_per_step": 0,
            "max_abs_err": k4_err,
            "ms": k4_ms[fp.N_BIG],
            "plain_ms": k4_plain_ms,
            "bound_ms": k4_bound[0],
            "bound_by": k4_bound[1],
            "library_ms": None,
        },
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
  and K3's patch table, block bounds and neighbour table into one workspace
  once a lens a trace (once a train step, once a 4K render), and the
  ray-pack kernel in the same source, which packs each chunk's rays;
* the fit loop (`fit_lens`, `fit_emitter_lens`: SGD and Adam, checkpoints
  and resume) on K1 and K2, and the rays made on the device (DeviceEmitter,
  OrthoGrid) with the renders that take them;
* mesh-vertex lens design (`models/design.py`: the patches rebuilt from the
  vertices inside every step) on K1 and the table kernel;
* the parallel layer (`parallel/`) on a one-rank NCCL group: the multihost
  renders and steps, and the patch-sharded intersection, which sweeps
  through K3, in the ('rays', 'patches') train step;
* the host stage on the native C++ runtime (`cbtr_tpu_torch/native`), and
  the driver and debug layer: `followers_report`, K3's third caller, the
  dense retry path, and BASELINE config 1 against the float64 oracle;
* the artifact scripts (`cbtr_tpu_torch/benchmarks/`): the 16,777,216-ray
  render, train step and emitter render through K1 and the table kernel,
  and the K1/K2 time decomposition;
* the segment-sum kernel (cbtr_tpu_torch/csrc/segment_sum.cu), the fixed-
  order sum behind the recompute's table gradient on every train, fit and
  design path and behind the scatter splat of every 4K path, which makes
  every gradient and image reproducible bit for bit in torch's default mode;
* the recompute kernels (cbtr_tpu_torch/csrc/recompute.cu), the
  differentiable re-evaluation of each ray's winning patch on every path:
  one forward launch a chunk a refraction, and in a backward one launch of
  its own unrolled-Newton reverse sweep.

Phases:

  0  a CUDA device (exit 1 without one), the card, the versions, the build
     of every kernel (one nvcc per source, in parallel) with each kernel's
     registers and spills (ptxas), K1's and K2's CTAs per SM; for every
     instantiation of K1-K3 (the sweep's four modes, K1's half_gate) its
     registers, stack and spills and (K1, K2) its CTAs per SM; and for each
     recompute kernel its registers, stack, spills and shared memory
     (ptxas) and the blocks an SM and occupancy the device gives it; the
     native
     preprocessing runtime built with g++ (its time; a failed build raises
     with g++'s message) before any scene, so every lens below starts from
     the JAX package's default mesh
  1  the headline scene, built by the port's own host stage on the native
     runtime (its calls counted)
  2  K1 against its plain twin at the full shape, the lowest-id tie rule;
     K1's per-tile counts and lists (its in-kernel cull) against the host
     list builder `tile_block_lists`, with and without the AABB leg, and
     its pass-1 pairs against `evaluated_pairs` (the unit-gated pairs that
     pass their own sphere and box), beside the pairs the unit gates
     admitted
  3  the render on K1 and on the plain twin
  4  three SGD train steps (the headline path; their launches counted,
     and `tile_block_lists`' calls: the GPU path never calls it); the
     loss must fall
  5  timings: CUDA events, median of 7 windows after warm-up; the rays of
     the step's second refraction, K1's lists and time there; both passes'
     evaluated pairs and K1's bound
  6  determinism: the headline gradient twice at one lens, equal bit for
     bit; the backward probe (harness/determinism.py: every node's
     gradients in two runs) finds no node that differs; two renders (the
     matmul splat) equal
  a  refined robot, P = 1800, 512^2: the routing (K2, never K1, above 1024
     patches), K2 against its twin on every ray and its lists against the
     host builder's, the render on K2 and on the twin, three SGD steps (the
     large-P path; launches counted, no `tile_block_lists` call),
     the gradient twice at one lens equal bit for bit, forward and
     fixed-lens step times, both passes' pairs and K2's bound
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
     patch table, the bounds at block 16 and 32, the neighbours, K2's
     clamped ones, K1's per-patch boxes; the four tables views of one
     workspace) on the robot,
     refined robot, split-4, split-6, dimpled solid, sphere 17 x 10 and
     ellipsoid 15 x 5; the ray pack `torch.equal` to `pad_rays` at 262,144,
     1,048,576 and 262,107 rays of the 4096^2 grid; each one's time (CUDA
     events), its own device time (torch.profiler's kernel events), the host
     time to issue it, the plain versions' and the bound (the kernels line
     takes the ray pack at 1,048,576 rays, whose 58.7 MB outrun the 50 MB
     L2; the 262,144-ray row is marked L2-warm); the device ops of
     one `prepare_inputs` (K1, K2, K3: 2, the build and the pack; K1 and K2
     on tables built once: 1); at the end, the table kernel's launches on
     every path (a train, fit, refined or design step, a 4K render, a 4K
     step, the emitter render, a `followers_report`): 1 each
  f  K3 against its twin at 65,536 x 450 (the bench's breakdown shape) and
     65,536 x 1800 (refined): codes on every pair, distances bit-equal on
     every cIntersect pair (the other pairs counted); its in-kernel counts
     and lists against `tile_block_lists(block_p=32)`, with and without the
     AABB leg, its evaluated pairs against `gated_pairs`; no
     `tile_block_lists` call inside the wrapper; the staged winners (K3,
     then select_candidates) against K1 or K2; recompute rejects on 4096
     rays; K3's time alone (on outputs filled once), with the output fill,
     with the fill and its tables, and its twin's
  q  the sweep's opt-in modes (config.fast_newton, config.bf16_sweep and
     both; the flags restored after each, whatever raised): K1 at the
     headline (262,144 x 450), K2 at the refined lens (262,144 x 1800) and
     K3 at 65,536 x 450, each torch.equal to its twin in the same mode on
     the first 65,536 rays (K3: codes, and distances on cIntersect pairs),
     its hits and winners against the default's, the exact recompute's
     rejects of its winners, its evaluated pairs and its time alone in
     turns with the default (exact, mode, mode, exact) with the share of the
     default's bound; K1 with half_gate in every mode torch.equal to its
     twin, its pass-1 pairs against `evaluated_pairs` beside the pairs its
     half gates admitted, its winners against half_gate=False and its
     time in turns (off, on, on, off); K1's and K2's pair counters under
     `profiling.counting()` equal to the launch's pairs on the same inputs
     and to the twin's count on the same rays (row "counter").  The
     kernels line carries each row under "modes"
  g  K4 against its twin (rtol 2e-6) at the short lengths fp.CHECK_LENGTHS,
     where the chains have not converged, and at both timing lengths;
     the FMA peak measured 3 times (fp.RUNS), every run and the card's ceiling
  h  `python -m cbtr_tpu_torch.bench --preset smoke` in a subprocess: its
     last line parses and holds the headline keys; its launch counts (reset
     at the bench's start, read at its end) show K1, K3 and K4 launched
  j  the fit loop on the headline (robot, 512^2, 128^2 zero target):
     `fit_lens` 6 SGD steps at phase 4's step size with a checkpoint every 2
     (launches counted: K1 12, tables 6, K2 0; the loss falls;
     ckpt_2/4/6 written); a fresh fit of 3 steps resumed to 6, and a second
     uninterrupted fit, against the first, in torch's default mode (both
     bit-equal to it) and in its deterministic mode (the resumed control
     points within 1e-6 x max |cp|, losses within 1e-5 relative); the
     resumed fit starts on the killed one's parameters bit
     for bit; ckpt_6 loaded back into LensParams gives the fit's loss; 3
     Adam steps fall; ms per fit step, SGD (also in the deterministic mode)
     and Adam
  k  the large-P fit: `fit_lens` 3 SGD steps on the refined robot (P = 1800,
     512^2): K2 6, K1 0, the loss falls; ms per fit step, SGD and Adam
  l  rays made on the device: DeviceEmitter (262,144 rays, 16 belts) on the
     card against its own CPU run (threefry draws, bins equal; directions
     and weights within 1e-6), sorted by bin, sum of weights n;
     render_emitter_image_device (2 K1 launches) against the host-sampled
     render_emitter_image (flux within 0.12); fit_emitter_lens 3 SGD steps
     at 5e-5 from a perturbed lens toward the true lens's image (the loss
     falls; the losses at 2.5e-4 and 1e-4, where the first step overshoots,
     printed; the fits at 5e-5 and 1e-4 run twice, the same losses);
     scene_ortho_grid(512).rays_at torch.equal to the scene's rays and its
     render to the host grid's image, at 4096^2 torch.equal to the host
     grid; render_surface_normals at 512^2 (1 K1 launch) against the plain
     twin; times of rays_at, the emitter renders and the 4096^2 grid;
     the emitter kernel (csrc/emitter.cu) at the emitter cell's 16,777,216
     rays against its plain version on the card (`_emitter_phase`: starts
     and weights equal, directions within one ulp, counted; a strided index
     at a seed above 2^32; a rank's quarter; one launch a synthesis and a
     render; its time against its bound and the plain version's; the peak)
  m  design at the configuration of benchmarks/design_lens.py's full run:
     the sphere 15 x 7 at LENS_CENTER (107 vertices, 630 patches), 262,144
     cone-lattice rays of 13 degrees, a 32^2 flat-top target (the rays and
     the target from cbtr_tpu_torch/benchmarks/design_lens.py) scaled to the
     initial flux; `patches_from_vertices` bit-equal between two calls (and
     the design loss and image), against `build_from_trimesh` and the CPU
     rebuild; loss and vertex gradient on the card against the CPU on 4096
     rays; the design gradient twice equal bit for bit and the backward
     probe on the design loss (no node differs); one design step's launches
     (K1 2, tables 1, ray pack 2, segment_sum 2); `fit_design` with
     stages [(5e-4, 8), (1e-4, 4)] (the best loss below the initial one) and
     its ms a step
  n  in a one-rank NCCL group (file:// store, 60 s timeout; a failure to
     start it fails the run): render_multihost, render_multihost_ortho(512^2)
     and render_multihost_emitter torch.equal to the single-process renders;
     3 SGD steps of each make_multihost_train_step* (the loss falls, the first
     gradient bit-equal to the single-process one);
     intersect_rays_patch_sharded on a 1 x 1 ('rays', 'patches') mesh at
     262,144 x 450 and x 1800 (K3 and tables 1 launch each, never K1 or K2;
     the rays whose winner differs from intersect_rays', agreement >= 0.999;
     recompute rejects on 4096 rays <= 4; peak memory); K3 on a table padded
     by pad_patches with cone rays from the origin; 3 SGD steps of the
     ('rays', 'patches') train step through refract_rays(intersect_fn=) (K3
     and tables 6 launches) and its fixed-lens time beside the K1 step's;
     entry() and dryrun_multichip(1)
  o  the native runtime against the NumPy path on the robot and the split-6
     robot (tests/test_native.py's bars) and the time of each on the host;
     `followers_report` at 262,144 x 450 (launches counted: K3 and
     tables 1 launch each) identical to the report the twin's codes give,
     against the unculled `intersect.sweep_codes` (the follow triples the
     cull drops counted, none added; both in chunks of 65,536 rays), its
     time and peak memory; BASELINE config 1 (sphere 15 x 7, 128^2 rays):
     both refractions, `screen_hits` and `render_lens_image` on K1 (4
     launches) against `FastReferenceTracer` on 1,024 seeded rays (per-ray
     disagreement <= 0.5 %, median position error < 5e-4); the dense path
     (`candidates_with_retry` + `select_best`) against `intersect_rays` on K1
     on the first 4,096 headline rays (the rays that differ, <= 4, and which
     one the scalar `ReferenceTracer` sides with), the dense path over the
     table's two halves `torch.equal` to the whole; `custom_stl_driver(robot,
     2, refine=True)` and `split_tall_driver` on the card, their STLs read
     back
  p  the artifact scripts (cbtr_tpu_torch/benchmarks/) at 16,777,216 rays:
     render4k (the 4096^2 grid -> a 1024^2 image), train4k (one fwd+bwd
     SGD step, 128^2 target) and emitter4k (DeviceEmitter, 64 belts, seed
     7 -> 256^2; the host path cut to 4,194,304 rays; one emitter step),
     each through its script's entry point with its launches counted,
     equal to exactly its renders' and steps'
     launches (the table kernel once a render or step, K1 and the ray pack
     once a chunk a refraction; the segment sum once a render and once
     more a chunk in a step), each
     script's two calls equal bit for bit (`deterministic`),
     each asserting what its JAX counterpart asserts (a finite, nonzero
     image; a finite, nonzero gradient; the two fluxes per ray within
     2 %), with its wall time, rays/s, peak memory and chunk; K1 on
     every chunk of both refractions of the 4K grid render and of the
     emitter render (all 16,777,216 rays of each pass) against its
     unit-gated twin on the tiles that list a block (0 rays differ; a tile
     that lists none a miss) and against K1 with the cull open (counted),
     each launch's engagement (the pairs the unit gates admitted, the pairs
     K1 evaluated, equal to `evaluated_pairs`); the K1 and K2 time
     decomposition (cull_probe.decomposition_rows: every block culled, none
     culled, the lens as it is; (b)'s winners against the unculled
     reference, (c)'s against the wrapper); K1 at blocks of 16 and 32 on
     the robot 1024^2 and on the first 1,048,576 rays of the 4K grid, the
     rays that differ and the side the unculled reference takes
  s  the segment-sum kernel against its plain version (`torch.equal`, no
     -0.0 out, and a second call bit-equal) at the main path's shapes: the
     headline recompute backward (262,144 x 60 into 450 patches, phase 2's
     K1 winners, misses at patch 0; int64 and int32 ids), a 4K chunk's (the
     first 1,048,576 rays of the 4096^2 grid), the 4K splat's (the
     67,108,864 pixel ids and contributions a 4K render hands it, into
     1024^2), edge shapes (empty segments, GROUP, GROUP + 1, GROUP^2 and
     GROUP^2 + 1 rows, C = 60 and 1), two sort passes (16,200 segments),
     three (5,000,000), the one-digit limit (2,047 and 2,048 segments, int32
     and int64 ids), every row dropped, and sparse two-pass splats into
     1024^2 (16 lit pixels; every row on one pixel); each one's time, its
     device ops (and the profiler sessions they took) and their device
     time by kernel (the grouping's share: the radix sort's kernels),
     its peak memory above its inputs, beside torch's `index_add_` (atomic,
     and in the deterministic mode), the plain version's and its bound; at
     most 10 device ops at the headline
  r  the recompute kernels against their plain versions at the headline
     (262,144 x 450 on K1's winners), the refined robot (262,144 x 1800 on
     K2's) and a 4K chunk (1,048,576 x 450 on K1's): every forward field
     torch.equal to the twin's; the backward's row, start and direction
     gradients torch.equal to `recompute_adjoint_reference` (cotangents on
     the hits, and on every ray) and to a second run, and within
     tests/test_torch_recompute.py (a)'s bar of autograd through the twin;
     each kernel's time, its own device time, its plain version's,
     autograd's through the twin, its peak memory and its bound (the plain
     versions' f32 operations, counted on the CPU, over the f32 peak, or its
     bytes over the HBM rate); the device ops of `recompute_winner` forward
     and with its backward on the kernels; at the headline, both kernels
     torch.equal to the plain versions at every Newton count (1-8), forward
     and backward.  It runs after phase t, before
     any long profiler session (a short call's records can go missing after
     one); at the end, every path's recompute launches (a train, fit,
     refined or design step 2 forward and 2 backward; a 4K render 32
     forward; a 4K step 32 forward and 32 backward: no chunk is
     checkpointed on the kernels)
  v  K1's second pass with the first pass's answers as its prior, at the
     4K beam's and the car-lamp fan's chunks: with it against without it
     on every ray, bit for bit, its reused tiles against the tiles with no
     live ray, both timed in turns beside the first pass; the renders'
     images and the headline step's loss and gradients with it and without
  u  the fit step's CUDA graph (`harness/step_graph.py`): on the headline
     (robot, 512^2, K1) and the refined robot (1024^2, K2), 6 Adam steps of
     `make_opt_train_step` (eager, capture, 4 replays) against an eager twin
     of its body on a copy of the lens, then a restart in place, a hooked
     (eager) step and 2 replays: winners, losses, gradients, parameters and
     launches torch.equal, the paths counted 1/4/1; ms a step replayed and
     eager, in turns; a 4K Adam step (16,777,216 rays in chunks of
     1,048,576) captured: its peak memory, what it holds between steps, ms
     a replay
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
import platform
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


def _train(lens_model, scene, learning_rate):
    """Three SGD steps with their launches and the host list builder's
    calls counted: returns (losses, |grad cp| max, grad n, {kernel:
    launches}); fails if the steps called the builder."""
    import torch

    from cbtr_tpu_torch.ops import cuda_lib
    from cbtr_tpu_torch.ops import cuda_sweep as cs

    target = torch.zeros((128, 128), dtype=torch.float32, device=scene.start.device)
    step = lens_model.make_train_step(scene.screen_plane, target, resolution=128,
                                      learning_rate=learning_rate)
    params = lens_model.params_from_scene(scene)
    losses = []

    def three_steps():
        nonlocal params
        for _ in range(3):
            params, loss = step(params, scene.start, scene.direction)
            torch.cuda.synchronize()
            g = params.control_points.grad
            assert torch.isfinite(loss) and torch.isfinite(g).all()
            assert float(g.abs().max()) > 0 and torch.isfinite(params.refractive_index.grad)
            losses.append(float(loss))
        return g

    with _calls(cs, "tile_block_lists") as list_calls:
        g, launches = cuda_lib.counted(three_steps)
    assert list_calls[0] == 0, list_calls
    launches["tile_block_lists"] = list_calls[0]
    assert losses[2] < losses[0], losses
    return losses, float(g.abs().max()), float(params.refractive_index.grad), launches


def _loss_fresh(params, scene, target):
    """The lens loss at params on the scene's rays, their gradients cleared:
    a fresh graph for the backward probe and the gradient-twice checks."""
    from cbtr_tpu_torch.models import lens_model

    params.zero_grad(set_to_none=True)
    return lens_model.lens_loss(params, scene.start, scene.direction, scene.screen_plane,
                                target, resolution=target.shape[0])


def _gradient_twice(params, scene, target):
    """(max |d grad cp|, |d grad n|, max |grad cp|) of two backward passes at
    one lens."""
    grads = []
    for _ in range(2):
        _loss_fresh(params, scene, target).backward()
        grads.append((params.control_points.grad.clone(), params.refractive_index.grad.clone()))
    return (float((grads[0][0] - grads[1][0]).abs().max()),
            float((grads[0][1] - grads[1][1]).abs()), float(grads[0][0].abs().max()))


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


def _engagement(cs, inputs, listed, half_gate=False):
    """(pairs the unit gates admitted, pairs that pass their own sphere and
    box): `gated_pairs` (what K2 evaluates) and `evaluated_pairs` (what K1
    evaluates) over the tiles' listed blocks [T, B], the real patches'
    columns."""
    P = inputs.num_patches
    admitted = evaluated = 0
    tiles_per_chunk = max(1, (1 << 25) // (cs.TILE_R * inputs.patch_t.shape[0]))
    for t0 in range(0, listed.shape[0], tiles_per_chunk):
        rt = inputs.rays_t[:, t0 * cs.TILE_R:(t0 + tiles_per_chunk) * cs.TILE_R]
        lt = listed[t0:t0 + tiles_per_chunk]
        sphere = cs.sphere_hit_pairs(inputs.patch_t, rt)
        admitted += int(cs.gated_pairs(lt, sphere, half_gate=half_gate)[:, :P].sum())
        evaluated += int(cs.evaluated_pairs(lt, sphere, cs.box_hit_pairs(inputs.boxes, rt))
                         [:, :P].sum())
    return admitted, evaluated


def _check_lists(cs, cw, stem, patches, start, direction, use_aabb=True, half_gate=False):
    """The kernel's in-kernel cull against the host list builder: per-tile
    counts equal, lists[:counts[t], t] equal; its pass-1 pairs against the
    pairs it evaluates (K1: `evaluated_pairs`, the unit-gated pairs that pass
    their own sphere and box, with its half_gate or without, printed beside
    the pairs the unit gates admitted; K2: `gated_pairs`).  Returns (inputs,
    listed fraction, pass-1 pairs, retries)."""
    import torch

    prepare = cw.prepare_inputs if stem == "winner" else cs.prepare_inputs
    inputs = prepare(patches, start, direction, use_aabb)
    out = cs.launch_kernel(stem, inputs, lists=True, pairs=True, half_gate=half_gate)
    counts, lists = cs.tile_block_lists(patches, inputs.rays_t, use_aabb=use_aabb)
    torch.cuda.synchronize()
    B, T = lists.shape
    assert torch.equal(out.counts, counts), (stem, patches.num_patches)
    mask = torch.arange(B, device=counts.device)[:, None] < counts[None, :]
    assert torch.equal(out.lists[mask], lists[mask]), (stem, patches.num_patches)
    listed = cs.listed_blocks(counts, lists, inputs.patch_t.shape[0])
    P = patches.num_patches
    got_pass1, retries = (int(x) for x in out.pairs.sum(dim=0, dtype=torch.int64))
    admitted, evaluated = _engagement(cs, inputs, listed, half_gate)
    pass1 = evaluated if stem == "sweep_select" else admitted
    if stem == "sweep_select":
        print(f"[k1] engagement at {start.shape[0]} x {P} (use_aabb={use_aabb}, half_gate="
              f"{half_gate}): the unit gates admitted {admitted} pairs, K1 evaluated "
              f"{got_pass1} ({got_pass1 / max(admitted, 1):.4f} of them)", flush=True)
    assert got_pass1 == pass1, (stem, P, got_pass1, pass1)
    return inputs, float(counts.sum()) / (B * T), pass1, retries


def _check_codes_lists(cs, cc, patches, start, direction, use_aabb):
    """K3's in-kernel cull (block 32) against `tile_block_lists`: per-tile
    counts equal, lists[:counts[t], t] equal; its evaluated pairs against
    `gated_pairs`.  Returns (inputs, listed fraction, evaluated pairs)."""
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
    executed = int(cs.gated_pairs(
        listed, cs.sphere_hit_pairs(inputs.patch_t, inputs.rays_t), cc.BLOCK_P)[:, :P].sum())
    got = int(out.pairs.sum(dtype=torch.int64))
    assert got == executed, ("K3", P, use_aabb, got, executed)
    return inputs, float(counts.sum()) / (B * T), executed


def _check_tables(ct, name, patches):
    """The table kernel against the plain versions on one lens, at block 16
    and 32 and with K2's clamped neighbours at block 16: every table
    `torch.equal` (K1's per-patch boxes: `_patch_boxes`), the four views of
    one workspace.  Returns max |kernel -
    plain| (0.0)."""
    import torch

    err = 0.0
    for block_p, clamp in ((16, False), (32, False), (16, True)):
        got = ct.build_tables(patches, block_p, clamp)
        want = ct.build_tables_reference(patches, block_p, clamp)
        torch.cuda.synchronize()
        assert (got.num_patches, got.block_p, got.clamped) == (
            want.num_patches, want.block_p, want.clamped), (name, block_p, clamp)
        assert len({t.untyped_storage().data_ptr() for t in (*got, got.boxes)}) == 1, \
            (name, block_p)
        for table, g, w in zip(("patch_t", "bounds", "nb", "boxes"), (*got, got.boxes),
                               (*want, want.boxes)):
            assert g.dtype == w.dtype and g.shape == w.shape, (name, block_p, clamp, table)
            assert torch.equal(g, w), (name, block_p, clamp, table, int((g != w).sum()))
            # empty blocks hold infinite box corners on both sides: inf - inf
            err = max(err, float((g.double() - w.double()).abs().nan_to_num(0.0).max()))
    return err


@contextlib.contextmanager
def _calls(module, name):
    """Counts the calls of `module.<name>` inside the block (every caller
    reaches it through the module: `cuda_sweep.tile_block_lists`,
    `native.preprocess`)."""
    calls = [0]
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls[0] += 1
        return fn(*args, **kwargs)

    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


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


# phase q: the sweep's opt-in modes (`intersect.MODES` names; exact is the
# default every other phase runs) and the rays a twin runs on
_OPT_MODES = ("fast", "bf16", "both")
_TWIN_RAYS = 65536


def _in_turns(fn, name: str, windows: int = 7) -> dict:
    """fn's time (CUDA events) in the sweep mode `name` (`intersect.MODES`)
    against the exact default, in turns: exact, name, name, exact.
    {"exact": [ms, ms], name: [ms, ms]}."""
    from cbtr_tpu_torch.ops import intersect as ix

    times = {"exact": [], name: []}
    for side in ("exact", name, name, "exact"):
        with ix.using_mode(ix.MODES[side]):
            times[side].append(_time_ms(fn, windows=windows))
    return times


def _modes_phase(card, scene, refined, bounds):
    """Phase q: K1 at the headline, K2 at the refined lens and K3 at 65,536 x
    450 in each opt-in mode (fast, bf16, both): `torch.equal` to the twin in
    the same mode on the first _TWIN_RAYS rays, agreement with the default
    (exact) run, recompute rejects, time in turns against the default; the
    wrapper's pair counter under `profiling.counting()` equal to the
    launch's `pairs` on the same inputs (K1 and K2, exact); K1
    with half_gate in every mode equal to its twin, its pass-1 pairs against
    `evaluated_pairs`, its winners against half_gate=False
    and its time in turns.  bounds: each kernel's default bound (ms), which
    every mode's share is taken against.  Returns {kernel: {mode: row}}."""
    import torch

    from cbtr_tpu_torch.ops import cuda_codes as cc
    from cbtr_tpu_torch.ops import cuda_sweep as cs
    from cbtr_tpu_torch.ops import cuda_winner as cw
    from cbtr_tpu_torch.ops import intersect as ix
    from cbtr_tpu_torch.utils import profiling

    rows = {"sweep_select": {}, "winner": {}, "sweep_codes": {}}
    n = _TWIN_RAYS
    for stem, sc, wrapper, twin, launch, prepare in (
            ("sweep_select", scene, cs.sweep_select, cs.sweep_select_reference, cs.launch,
             cs.prepare_inputs),
            ("winner", refined, cw.sweep_winner, cw.sweep_winner_reference, cw.launch,
             cw.prepare_inputs)):
        p, s, d = sc.patches, sc.start, sc.direction
        inputs = prepare(p, s, d)
        default = wrapper(p, s, d)
        # the wrapper's own counter (profiling.counting) on the same inputs
        cs.reset_pair_counts()
        with profiling.counting():
            counted_out = wrapper(p, s, d)
        counted = cs.pair_counts()[stem]
        cs.reset_pair_counts()
        asked = tuple(int(x) for x in launch(inputs, pairs=True).pairs.sum(dim=0,
                                                                            dtype=torch.int64))
        same = all(torch.equal(a, b) for a, b in zip(counted_out, default))
        with profiling.counting():
            twin(p, s, d)
        twin_counted = cs.pair_counts()[stem]
        cs.reset_pair_counts()
        rows[stem]["counter"] = dict(counted=list(counted), pairs=list(asked), same_winners=same,
                                     twin_pass1=twin_counted[0])
        print(f"[q] {card} | {stem} {s.shape[0]} x {p.num_patches}: its counter under "
              f"profiling.counting() {counted} (pass-1 pairs, retries), the launch's pairs "
              f"{asked}, the twin's pass-1 pairs {twin_counted[0]}; winners equal to the "
              f"uncounted call's {same}", flush=True)
        assert counted == asked and counted[0] > 0 and same, (stem, counted, asked, same)
        assert twin_counted[0] == counted[0], (stem, twin_counted, counted)
        for name in _OPT_MODES:
            with ix.using_mode(ix.MODES[name]):
                got = wrapper(p, s, d)
                ref = twin(p, s[:n], d[:n])
                torch.cuda.synchronize()
                equal = all(torch.equal(a[:n], b) for a, b in zip(got, ref))
                pairs = launch(inputs, pairs=True).pairs.sum(dim=0, dtype=torch.int64)
            cmp = _compare(got, default)
            _, rejects = ix.recompute_winner(p, s, d, got[0], got[1], with_check=True)
            times = _in_turns(lambda: launch(inputs), name)
            ms = min(times[name])
            rows[stem][name] = dict(
                equal_to_twin=equal, twin_rays=n, hit_agreement=cmp[0],
                winner_agreement=cmp[1], rays_differ=cmp[4], rejects=rejects,
                pairs=[int(x) for x in pairs], ms=times[name], default_ms=times["exact"],
                share=bounds[stem] / ms)
            print(f"[q] {card} | {stem} {s.shape[0]} x {p.num_patches}, mode {name}: "
                  f"torch.equal to its twin on the first {n} rays {equal}; against the "
                  f"default: any_hit agreement {cmp[0]:.6f}, win agreement on {cmp[3]} common "
                  f"hits {cmp[1]:.6f}, {cmp[4]} rays differ; recompute rejects {rejects}; "
                  f"pass-1 pairs {int(pairs[0])} + {int(pairs[1])} retries; kernel alone in "
                  f"turns (exact, {name}, {name}, exact) {times['exact'][0]:.4f}, "
                  f"{times[name][0]:.4f}, {times[name][1]:.4f}, {times['exact'][1]:.4f} ms; "
                  f"share of the default's bound {bounds[stem]:.4f} ms: {bounds[stem] / ms:.3f}",
                  flush=True)
            assert equal, (stem, name)
        del inputs, default, got, ref

    # K1 with half_gate: every mode against its twin, the default timed
    p, s, d = scene.patches, scene.start, scene.direction
    inputs = cs.prepare_inputs(p, s, d)
    plain_gate = cs.sweep_select(p, s, d)
    for name in ("exact", *_OPT_MODES):
        with ix.using_mode(ix.MODES[name]):
            got = cs.sweep_select(p, s, d, half_gate=True)
            ref = cs.sweep_select_reference(p, s[:n], d[:n], half_gate=True)
            torch.cuda.synchronize()
            equal = all(torch.equal(a[:n], b) for a, b in zip(got, ref))
        print(f"[q] K1 half_gate, mode {name}: torch.equal to its twin on the first {n} rays "
              f"{equal}", flush=True)
        assert equal, ("half_gate", name)
        if name == "exact":
            half = got
    _, _, pass1, retries = _check_lists(cs, None, "sweep_select", p, s, d, half_gate=True)
    cmp = _compare(half, plain_gate)
    times = {"half_gate=False": [], "half_gate=True": []}
    for gate in (False, True, True, False):
        times[f"half_gate={gate}"].append(
            _time_ms(lambda: cs.launch(inputs, half_gate=gate), windows=7))
    ms = min(times["half_gate=True"])
    rows["sweep_select"]["half_gate"] = dict(
        equal_to_twin=True, twin_rays=n, hit_agreement=cmp[0], winner_agreement=cmp[1],
        rays_differ=cmp[4], pairs=[pass1, retries], ms=times["half_gate=True"],
        default_ms=times["half_gate=False"], share=bounds["sweep_select"] / ms)
    print(f"[q] {card} | K1 half_gate {s.shape[0]} x {p.num_patches}: pass-1 pairs {pass1} "
          f"(= evaluated_pairs) + {retries} retries; against half_gate=False: "
          f"any_hit agreement {cmp[0]:.6f}, win agreement {cmp[1]:.6f}, {cmp[4]} rays differ; "
          f"kernel alone in turns (off, on, on, off) {times['half_gate=False'][0]:.4f}, "
          f"{times['half_gate=True'][0]:.4f}, {times['half_gate=True'][1]:.4f}, "
          f"{times['half_gate=False'][1]:.4f} ms", flush=True)
    del inputs, plain_gate, half, got, ref

    # K3 at the bench's breakdown shape
    s, d = s[:n], d[:n]
    k3_in = cc.prepare_inputs(p, s, d)
    k3_out = cc.filled_outputs(k3_in)
    code0, dist0 = cc.sweep_codes_cuda(p, s, d)
    for name in _OPT_MODES:
        with ix.using_mode(ix.MODES[name]):
            code, dist = cc.sweep_codes_cuda(p, s, d)
            code_r, dist_r = cc.sweep_codes_reference(p, s, d)
            torch.cuda.synchronize()
            inter = (code_r & 7) == ix.WHAT_INTERSECT
            equal = torch.equal(code, code_r) and torch.equal(dist[inter], dist_r[inter])
            executed = int(cc.launch(k3_in, pairs=True).pairs.sum(dtype=torch.int64))
        codes_differ = int((code != code0).sum())
        staged = ix.select_candidates(code, dist, p.neighbours)
        staged0 = ix.select_candidates(code0, dist0, p.neighbours)
        cmp = _compare(staged, staged0)
        _, rejects = ix.recompute_winner(p, s, d, staged[0], staged[1], with_check=True)
        times = _in_turns(lambda: cc.launch(k3_in, k3_out), name)
        ms = min(times[name])
        rows["sweep_codes"][name] = dict(
            equal_to_twin=equal, twin_rays=n, codes_differ=codes_differ,
            hit_agreement=cmp[0], winner_agreement=cmp[1], rays_differ=cmp[4],
            rejects=rejects, pairs=executed,
            ms=times[name], default_ms=times["exact"], share=bounds["sweep_codes"] / ms)
        print(f"[q] {card} | sweep_codes {n} x {p.num_patches}, mode {name}: codes and "
              f"cIntersect distances torch.equal to its twin {equal}; pairs with another code "
              f"than the default's {codes_differ} of {code.numel()}; staged winners against "
              f"the default's: any_hit agreement {cmp[0]:.6f}, win agreement {cmp[1]:.6f}; "
              f"recompute rejects {rejects}; evaluated pairs {executed}; kernel alone in turns "
              f"{times['exact'][0]:.4f}, {times[name][0]:.4f}, {times[name][1]:.4f}, "
              f"{times['exact'][1]:.4f} ms; share of the default's bound "
              f"{bounds['sweep_codes']:.4f} ms: {bounds['sweep_codes'] / ms:.3f}", flush=True)
        assert equal, ("sweep_codes", name)
        del code, dist, code_r, dist_r, inter, staged, staged0
    del k3_in, k3_out, code0, dist0
    torch.cuda.empty_cache()
    return rows


def _render(scene, backend="auto"):
    import torch

    from cbtr_tpu_torch.render.render import render_lens_image

    with torch.no_grad():
        return render_lens_image(scene.patches, scene.refractive_index, scene.start,
                                 scene.direction, scene.screen_plane, resolution=128,
                                 backend=backend)


@contextlib.contextmanager
def _deterministic(on: bool):
    """torch's deterministic algorithms inside the block, if `on`: the
    cross-check of the default mode, whose sums are fixed-order already."""
    import torch

    torch.use_deterministic_algorithms(on, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _fit_step_ms(fit_lens, sc, target, optimizer, learning_rate, steps=4) -> float:
    """Host-clock ms per step of a `fit_lens` run (each step reads its loss
    back, so the clock covers the device), after a one-step warm-up."""
    import torch

    fit_lens(sc, target, 1, learning_rate=learning_rate, optimizer=optimizer)
    torch.cuda.synchronize()
    t = time.perf_counter()
    fit_lens(sc, target, steps, learning_rate=learning_rate, optimizer=optimizer)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / steps * 1e3


def _rays_differ(a, b) -> int:
    """Rays whose (any_hit, winner, distance) differ between two winner
    searches' results: the hit flag, or on a hit the winner or the
    distance's bits."""
    import torch

    hit = a[0] & b[0]
    return int(((a[0] != b[0]) | (hit & ((a[1] != b[1])
                                          | (a[2].view(torch.int32) != b[2].view(torch.int32)))))
               .sum())


def _k1_every_chunk(cs, patches, render, label: str, chunks: int):
    """Every chunk `render()` hands the winner search in its two refractions
    (`chunks` each), checked as it passes (`intersect._winner_chunk`): K1
    (`launch`, with its pairs) against its twin on the rays of the tiles
    that list a block, those tiles' rays kept whole and in order (a tile
    that lists none is a miss, asserted), and against K1 with the cull open
    (`cull_probe.uncull_inputs`); each launch's engagement printed (the
    pairs the unit gates admitted, the pairs K1 evaluated, asserted equal
    to `evaluated_pairs`).  Returns one dict a refraction: rays, chunks,
    twin rays, rays that differ from the twin and from the open cull,
    admitted and evaluated pairs, retries."""
    import torch

    from cbtr_tpu_torch.benchmarks import cull_probe
    from cbtr_tpu_torch.ops import intersect as ix

    keys = ("rays", "chunks", "twin_rays", "differ_twin", "differ_open", "admitted",
            "evaluated", "retries")
    rows = [dict.fromkeys(keys, 0) for _ in range(2)]
    search, calls = ix._winner_chunk, [0]

    def check(p, start, direction, *args, **kwargs):
        result = search(p, start, direction, *args, **kwargs)
        R = start.shape[0]
        inputs = cs.prepare_inputs(patches, start, direction)
        out = cs.launch(inputs, pairs=True)
        k1 = (out.dist[:R] < cs._BIG_F * 0.5, out.win[:R], out.dist[:R])
        tiles = torch.nonzero(out.counts > 0)[:, 0]
        rays = (tiles[:, None] * cs.TILE_R
                + torch.arange(cs.TILE_R, device=tiles.device)[None, :]).reshape(-1)
        rays = rays[rays < R]
        quiet = torch.ones(R, dtype=torch.bool, device=start.device)
        quiet[rays] = False
        assert not bool(k1[0][quiet].any()), (label, "a tile that lists no block hit")
        differ_twin = 0
        if rays.numel():
            twin = cs.sweep_select_reference(patches, start[rays], direction[rays])
            differ_twin = _rays_differ(tuple(x[rays] for x in k1), twin)
        wide = cs.launch(cull_probe.uncull_inputs(inputs))
        differ_open = _rays_differ(k1, (wide.dist[:R] < cs._BIG_F * 0.5, wide.win[:R],
                                        wide.dist[:R]))
        admitted, evaluated = _engagement(
            cs, inputs, cs.tile_bitmap_reference(inputs.bounds, inputs.rays_t))
        pass1, retries = (int(x) for x in out.pairs.sum(dim=0, dtype=torch.int64))
        assert pass1 == evaluated, (label, calls[0], pass1, evaluated)
        print(f"[k1] engagement, {label} call {calls[0]}: {R} rays, the unit gates admitted "
              f"{admitted} pairs, K1 evaluated {pass1} + {retries} retries", flush=True)
        row = rows[calls[0] // chunks]
        for key, value in zip(keys, (R, 1, int(rays.numel()), differ_twin, differ_open,
                                     admitted, pass1, retries)):
            row[key] += value
        calls[0] += 1
        return result

    ix._winner_chunk = check
    try:
        with torch.no_grad():
            render()
    finally:
        ix._winner_chunk = search
    assert calls[0] == 2 * chunks, (label, calls, chunks)
    return rows


def _bin_sorted_fraction(d, belts: int) -> float:
    """Share of adjacent rays whose reference belt/patch bin, recomputed from
    the directions (reference/hostUtil.cpp:9-13), does not decrease."""
    import numpy as np

    from cbtr_tpu_torch.render.emitters import UniformHemisphere, belt_patch_counts

    d = d.cpu().numpy()
    hemi = UniformHemisphere(belts=belts)
    incidence = np.arccos(np.clip(d[:, 0], -1.0, 1.0))
    turn = np.arctan2(d[:, 2], d[:, 1]) % (2 * np.pi)
    belt = np.minimum((incidence / hemi.belt_width).astype(np.int64), belts - 1)
    patch = hemi.patch_starts[belt] + np.minimum(
        (turn / hemi.patch_widths[belt]).astype(np.int64), belt_patch_counts(belts)[belt] - 1)
    return float(np.mean(np.diff(patch) >= 0))


def _ordered_bits(x):
    """float32 x as int64 in the floats' order (so that the distance of two
    is the count of floats between them, in ulps)."""
    import torch

    i = x.view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def _emitter_phase(dev, card) -> dict:
    """Phase l's emitter kernel (csrc/emitter.cu) at the emitter cell's
    shape, 16,777,216 rays of `benchmarks/emitter4k.device_emitter()` (64
    belts, seed 7): `synthesize` against its plain version
    `synthesize_reference` on the card, the elements of each output that
    differ and the largest ulp of a direction component (at most 1;
    starts and weights equal), the same for a seed above 2^32 at every
    third index (a strided index), and a rank's quarter equal to the same
    slice of the whole; one launch a `synthesize` and one a render
    (`render_multihost_emitter` on a group of one); the kernel's ms (CUDA
    events around the launch, and its own device time: the mean over the
    launches the profiler saw) against its bound (28 B a ray at the HBM rate) and the plain version's
    ms; the peak memory of each."""
    import torch

    from cbtr_tpu_torch.benchmarks import emitter4k
    from cbtr_tpu_torch.harness import kernel_ab
    from cbtr_tpu_torch.models import robot_lens_scene
    from cbtr_tpu_torch.ops import cuda_emitter, cuda_lib
    from cbtr_tpu_torch.parallel.multihost import multihost_mesh, render_multihost_emitter
    from cbtr_tpu_torch.render import emitters

    em = emitter4k.device_emitter()
    n = em.n_rays
    idx = torch.arange(n, device=dev)

    def peak_of(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated(dev) - base

    def held(got, want, label):
        differ = [int((a != b).sum()) for a, b in zip(got, want)]
        ulps = (_ordered_bits(got[1]) - _ordered_bits(want[1])).abs()
        counts = torch.bincount(ulps.flatten()).tolist()
        print(f"[l] emitter kernel vs synthesize_reference on the card, {label}: elements "
              f"differing (start, direction, weight) {differ} of {got[1].shape[0]} rays; "
              f"direction components by ulps 0, 1, ...: {counts}", flush=True)
        assert differ[0] == 0 and differ[2] == 0 and len(counts) <= 2, (label, differ, counts)
        return differ, counts

    (got, launches), k_peak = peak_of(lambda: cuda_lib.counted(
        lambda: emitters.synthesize(em, idx)))
    assert launches["emitter"] == 1 and sum(launches.values()) == 1, launches
    want, p_peak = peak_of(lambda: emitters.synthesize_reference(em, idx))
    whole = held(got, want, f"{n} rays, seed {em.seed}")
    del want
    quarter = idx[n // 4:n // 2]
    assert all(torch.equal(a, b[quarter]) for a, b in zip(emitters.synthesize(em, quarter), got))
    far = em._replace(seed=(1 << 32) + 7)
    strided = idx[1::3]
    held(emitters.synthesize(far, strided), emitters.synthesize_reference(far, strided),
         f"seed 2^32 + 7, every third index")

    tables = em._device_tables(dev)

    def launch():
        return cuda_emitter.launch(tables, idx, em.seed, em.origin, n)

    # the profiler can drop a launch's record inside this script (PERF.md §7):
    # the kernel's own time is the mean over the launches it saw
    ops, _, per, _ = kernel_ab.device_kernels(lambda: [launch() for _ in range(20)],
                                              ("emitter_kernel",))
    assert set(per) == {"emitter_kernel"}, per
    ms = {"events": _time_ms(launch, windows=7, inner=10), "kernel": per["emitter_kernel"] / ops,
          "plain": _time_ms(lambda: emitters.synthesize_reference(em, idx), windows=3, inner=1)}
    bound = 28 * n / PEAK_BYTES_PER_S * 1e3

    sc = robot_lens_scene(res=1, device=dev)
    with torch.no_grad():
        _, render_launches = cuda_lib.counted(lambda: render_multihost_emitter(
            multihost_mesh(), sc.patches, sc.refractive_index, em, sc.screen_plane,
            resolution=256, chunk_size=1 << 20))
    assert render_launches["emitter"] == 1, render_launches
    print(f"[l] {card} | emitter kernel {n} rays: {ms['events']:.4f} ms (CUDA events), "
          f"{ms['kernel']:.4f} ms its own device time, bound {bound:.4f} ms (28 B a ray at "
          f"3.35 TB/s: {100 * bound / ms['kernel']:.1f} %), plain version "
          f"{ms['plain']:.3f} ms ({ms['plain'] / ms['events']:.0f}x); peak memory above its "
          f"inputs {k_peak} B, the plain version's {p_peak} B; launches a synthesize "
          f"{launches['emitter']}, a render {render_launches['emitter']}", flush=True)
    return {"rays": n, "ms": ms, "bound_ms": bound, "peak_bytes": k_peak,
            "plain_peak_bytes": p_peak, "differ": whole[0], "direction_ulps": whole[1]}


def _design_phase(dev, card):
    """Phase m: the design configuration of benchmarks/design_lens.py's full
    run (DESIGN_r05.json): the sphere 15 x 7 at LENS_CENTER (107 vertices,
    630 patches: K1), 262,144 cone-lattice rays of 13 degrees, a 32^2 image
    of extent 4, a flat-top target (radius 1.2, sigma 0.15) scaled to the
    initial lens's flux.  Returns a dict of what it measured."""
    import torch

    from cbtr_tpu_torch.benchmarks.design_lens import cone_lattice_rays, structured_target
    from cbtr_tpu_torch.harness.determinism import divergent_sites
    from cbtr_tpu_torch.bezier import build_from_trimesh
    from cbtr_tpu_torch.harness import preprocess
    from cbtr_tpu_torch.mesh.core import make_unit_sphere
    from cbtr_tpu_torch.models import design, scenes
    from cbtr_tpu_torch.ops import cuda_lib

    lamp = preprocess(make_unit_sphere(15, 7))
    lamp.translate(scenes.LENS_CENTER)
    lamp = preprocess(lamp)
    topo, p0 = design.topology_from_mesh(lamp, device=dev)
    topo_cpu, p_cpu = design.topology_from_mesh(lamp, device="cpu")
    with torch.no_grad():
        built = design.patches_from_vertices(p0, topo)
        again = design.patches_from_vertices(p0, topo)
        on_cpu = design.patches_from_vertices(p_cpu, topo_cpu)
    host = build_from_trimesh(lamp, device=dev)
    torch.cuda.synchronize()
    assert (built.num_patches, p0.vertices.shape[0]) == (630, 107), built.num_patches
    gaps = {}    # leaf -> max |d| / max |leaf| against the host build, the CPU rebuild
    for name, leaf in built.leaves().items():
        # the forward is reproducible on the card: the corner sums run in a
        # fixed order (no atomics), so every table is bit-equal between calls
        assert torch.equal(leaf, getattr(again, name)), name
        if name == "neighbours":
            assert torch.equal(leaf, host.neighbours) and torch.equal(leaf.cpu(), on_cpu.neighbours)
            continue
        scale = float(leaf.abs().max())
        gaps[name] = (float((leaf - getattr(host, name)).abs().max()) / scale,
                      float((leaf.cpu() - getattr(on_cpu, name)).abs().max()) / scale)
    # Far from the origin the barycentric inverse is ill-conditioned (entries
    # up to 1.5e4 on this lens): there the f32 rebuild and the host build
    # differ by up to 2.3e-3 of a leaf's largest entry in the port and 2.0e-3
    # in the JAX package (CPU), against 2e-5 absolute for the untranslated
    # sphere of tests/test_torch_design.py.  A wrong build is off by O(1).
    assert max(max(g) for g in gaps.values()) <= 5e-3, gaps

    n_rays, res, extent = 262144, 32, 4.0
    start, direction = cone_lattice_rays(n_rays, 13.0, dev)
    screen = torch.tensor([1.0, 0.0, 0.0, 10.0], dtype=torch.float32, device=dev)
    with torch.no_grad():
        _, img0 = design.design_loss(p0, topo, start, direction, screen,
                                     torch.ones((res, res), device=dev), resolution=res,
                                     extent=extent)
        flat = structured_target("flat", res, extent, 1.2, 0.15)
        target = torch.as_tensor(flat * (float(img0.sum()) / float(flat.sum())), device=dev)
        loss_a, img_a = design.design_loss(p0, topo, start, direction, screen, target,
                                           resolution=res, extent=extent)
        loss_b, img_b = design.design_loss(p0, topo, start, direction, screen, target,
                                           resolution=res, extent=extent)
    assert torch.equal(img_a, img_b) and torch.equal(loss_a, loss_b), "design forward moved"

    # the card against the port's CPU run on the first 4096 rays, at the bars
    # of tests/test_torch_lens_model.py (loss 1e-4 relative, gradients 1e-3):
    # sqrt and arccos round otherwise on the two devices (measured: loss
    # 6.9e-6, vertex gradient 1.1e-4 of its max, index gradient 1.9e-5)
    runs = []
    for where in (dev, torch.device("cpu")):
        topo_w, p_w = design.topology_from_mesh(lamp, device=where)
        loss, _ = design.design_loss(p_w, topo_w, start[:4096].to(where),
                                     direction[:4096].to(where), screen.to(where),
                                     target.to(where), resolution=res, extent=extent)
        loss.backward()
        runs.append((loss.item(), p_w.vertices.grad.cpu(), p_w.refractive_index.grad.item()))
    (l_card, g_card, n_card), (l_cpu, g_cpu, n_cpu) = runs
    g_gap = float((g_card - g_cpu).abs().max()) / float(g_cpu.abs().max())
    loss_gap, n_gap = abs(l_card - l_cpu) / abs(l_cpu), abs(n_card - n_cpu) / abs(n_cpu)
    assert loss_gap <= 1e-4 and g_gap <= 1e-3 and n_gap <= 1e-3, (loss_gap, g_gap, n_gap)

    # the design gradient twice at one iterate, all rays, and the backward
    # probe: the nodes whose gradients move between two runs, and where
    repeat = []
    for _ in range(2):
        p0.zero_grad(set_to_none=True)
        design.design_loss(p0, topo, start, direction, screen, target, resolution=res,
                           extent=extent)[0].backward()
        repeat.append((p0.vertices.grad.clone(), p0.refractive_index.grad.clone()))
    torch.cuda.synchronize()
    g_repeat = (float((repeat[0][0] - repeat[1][0]).abs().max()),
                float(repeat[0][0].abs().max()),
                float((repeat[0][1] - repeat[1][1]).abs()))

    def fresh_loss():
        p0.zero_grad(set_to_none=True)
        return design.design_loss(p0, topo, start, direction, screen, target,
                                  resolution=res, extent=extent)[0]

    sites, nodes, differ = divergent_sites(fresh_loss)
    p0.zero_grad(set_to_none=True)
    print(f"[m] the design gradient twice at one iterate: max |d grad v| {g_repeat[0]:.3e} "
          f"of max |grad v| {g_repeat[1]:.4e}, |d grad n| {g_repeat[2]:.3e}; backward probe: "
          f"{differ} of {nodes} nodes give other gradients in a second run, order-dependent "
          f"sites {sites}", flush=True)
    assert g_repeat[0] == 0.0 and g_repeat[2] == 0.0 and differ == 0 and sites == [], \
        (g_repeat, sites)

    step = design.make_design_step(topo, screen, target, resolution=res, extent=extent)
    opt = torch.optim.Adam(p0.parameters(), lr=5e-4)
    _, step_launches = cuda_lib.counted(lambda: step(p0, opt, start, direction))
    # the tables once a step (both refractions share them), one ray pack a pass
    assert step_launches == {"sweep_select": 2, "winner": 0, "sweep_codes": 0,
                             "fma_chains": 0, "tables": 1, "pack_rays": 2,
                             "segment_sum": 2, "recompute_forward": 2,
                             "recompute_backward": 2, "emitter": 0}, step_launches

    stages = [(5e-4, 8), (1e-4, 4)]
    n_steps = sum(n for _, n in stages)
    torch.cuda.synchronize()
    t = time.perf_counter()
    (best, _, losses), fit_launches = cuda_lib.counted(lambda: design.fit_design(
        lamp, target, start, direction, screen, stages=stages, resolution=res,
        extent=extent, device=dev))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) / n_steps * 1e3
    assert fit_launches == {"sweep_select": 2 * n_steps, "winner": 0, "sweep_codes": 0,
                            "fma_chains": 0, "tables": n_steps, "pack_rays": 2 * n_steps,
                            "segment_sum": 2 * n_steps, "recompute_forward": 2 * n_steps,
                            "recompute_backward": 2 * n_steps, "emitter": 0}, fit_launches
    assert torch.isfinite(best.vertices).all() and min(losses) < losses[0], losses
    print(f"[m] design: sphere 15 x 7 at LENS_CENTER ({p0.vertices.shape[0]} vertices, "
          f"{built.num_patches} patches), {n_rays} cone-lattice rays (13 deg), {res}^2 "
          f"flat-top target; patches_from_vertices bit-equal between two calls, and so are "
          f"the design loss and image; (max |d| / max |leaf|) against build_from_trimesh "
          f"and against the CPU rebuild {gaps}; card vs CPU on 4096 rays: loss {l_card!r} vs {l_cpu!r} (gap "
          f"{loss_gap:.3e}), max |d grad v| / max |grad v| {g_gap:.3e}, index gradient gap "
          f"{n_gap:.3e}; one design step launches {step_launches}; fit_design {stages}: "
          f"losses {[round(x, 6) for x in losses]}, best {min(losses):.6f} at step "
          f"{losses.index(min(losses))} (initial {losses[0]:.6f}), launches {fit_launches}",
          flush=True)
    print(f"[m] {card} | design step {n_rays} rays x {built.num_patches} patches (Adam, "
          f"patches rebuilt from the vertices, host clock around fit_design): "
          f"{step_ms:.3f} ms", flush=True)
    return {"step_ms": step_ms, "launches": fit_launches, "steps": n_steps,
            "cone": (start, direction)}


def _parallel_phase(dev, card, scene, refined, em, cone):
    """Phase n, inside a one-rank NCCL group: the multihost renders and steps
    against the single-process ones, the patch-sharded intersection (K3)
    against K1 and K2, the ('rays', 'patches') train step, entry and
    dryrun_multichip.  Returns a dict of what it measured."""
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from cbtr_tpu_torch import entry
    from cbtr_tpu_torch.models import lens_model, scene_ortho_grid
    from cbtr_tpu_torch.ops import cuda_codes as cc
    from cbtr_tpu_torch.ops import cuda_lib
    from cbtr_tpu_torch.ops import intersect as ix
    from cbtr_tpu_torch.parallel import multihost as mh
    from cbtr_tpu_torch.parallel import sharding
    from cbtr_tpu_torch.parallel.patch_parallel import intersect_rays_patch_sharded, pad_patches
    from cbtr_tpu_torch.render import render as rd

    patches, start, direction = scene.patches, scene.start, scene.direction
    screen, n_refr, R = scene.screen_plane, scene.refractive_index, scene.start.shape[0]
    mesh = mh.multihost_mesh()
    assert mesh is not None and mesh.size() == 1 and mesh.device_type == dev.type, mesh

    # renders: a one-rank all-reduce is the identity, the weights of
    # process_ray_shard are all 1 and the grid's rays are the scene's
    with torch.no_grad():
        got = {"uploaded": mh.render_multihost(mesh, patches, n_refr, start, direction, screen),
               "ortho": mh.render_multihost_ortho(mesh, patches, n_refr, scene_ortho_grid(512),
                                                  screen),
               "emitter": mh.render_multihost_emitter(mesh, patches, n_refr, em, screen)}
        ref = _render(scene)
        ref_e = rd.render_emitter_image_device(patches, n_refr, em, screen)
    wants = {"uploaded": ref, "ortho": ref, "emitter": ref_e}
    gaps = {k: float((got[k] - wants[k]).abs().max()) for k in got}
    assert all(torch.equal(got[k], wants[k]) for k in got), gaps

    # three SGD steps of each multihost step; the first gradient against the
    # single-process gradient at the same lens: a one-rank all-reduce is the
    # identity and every sum is fixed-order, so the two are bit-equal
    e_idx = torch.arange(em.n_rays, device=dev)
    es, ed, ew = em.rays_at(e_idx)
    zero = torch.zeros((128, 128), dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    bump = torch.as_tensor(rng.normal(scale=2e-3, size=tuple(patches.control_points.shape))
                           .astype(np.float32), device=dev)

    def fresh():
        return lens_model.params_from_scene(scene)

    def perturbed():
        p = fresh()
        with torch.no_grad():
            p.control_points += bump
            p.refractive_index += 0.01
        return p

    variants = {
        "uploaded": (lambda: mh.make_multihost_train_step(mesh, screen, zero,
                                                          learning_rate=2.5e-7),
                     lambda st, p: st(p, start, direction) + (None,),
                     fresh, (start, direction, None), zero),
        "ortho": (lambda: mh.make_multihost_train_step_ortho(mesh, screen, zero,
                                                             scene_ortho_grid(512),
                                                             learning_rate=2.5e-7),
                  lambda st, p: st(p), fresh, (start, direction, None), zero),
        # phase l's emitter fit took 2.5e-4; on the device emitter's own image
        # its third step overshot (0.1085, 0.0949, 0.1552)
        "emitter": (lambda: mh.make_multihost_train_step_emitter(mesh, screen, ref_e, em,
                                                                 learning_rate=1e-4),
                    lambda st, p: st(p), perturbed, (es, ed, ew), ref_e),
    }
    steps_out = {}
    for name, (make, call, init, (s, d, w), target) in variants.items():
        p_ref = init()
        lens_model.lens_loss(p_ref, s, d, screen, target, ray_weights=w).backward()
        g_ref = p_ref.control_points.grad
        st, p = make(), init()
        losses, gap = [], None
        for _ in range(3):
            p, loss, _ = call(st, p)
            if gap is None:
                gap = float((p.control_points.grad - g_ref).abs().max())
            losses.append(float(loss))
        g_max = float(g_ref.abs().max())
        assert np.isfinite(losses).all() and losses[2] < losses[0], (name, losses)
        assert gap == 0.0, (name, gap, g_max)
        steps_out[name] = (losses, gap, g_max)

    # the patch-sharded intersection on a 1 x 1 ('rays', 'patches') mesh
    mesh2 = init_device_mesh(dev.type, (1, 1), mesh_dim_names=("rays", "patches"))
    rows = {}
    for name, sc in (("robot", scene), ("refined", refined)):
        p, s, d = sc.patches, sc.start, sc.direction
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        with torch.no_grad():
            hit, launches = cuda_lib.counted(lambda: intersect_rays_patch_sharded(
                p, s, d, mesh2, ray_axis="rays"))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        assert launches == {"sweep_select": 0, "winner": 0, "sweep_codes": 1,
                            "fma_chains": 0, "tables": 1, "pack_rays": 1,
                            "segment_sum": 0, "recompute_forward": 1,
                            "recompute_backward": 0, "emitter": 0}, (name, launches)
        with torch.no_grad():
            want, direct = cuda_lib.counted(lambda: ix.intersect_rays(p, s, d))
        ok, ok_w = hit.what == ix.WHAT_INTERSECT, want.what == ix.WHAT_INTERSECT
        differ = int(((ok != ok_w) | (ok & ok_w & (hit.patch != want.patch))).sum())
        _, rejects = ix.recompute_winner(p, s[:4096], d[:4096], ok[:4096], hit.patch[:4096],
                                         with_check=True)
        assert 1.0 - differ / R >= 0.999 and rejects <= 4, (name, differ, rejects)
        kernel = "K1" if direct["sweep_select"] else "K2"
        ms = _time_ms(lambda: intersect_rays_patch_sharded(p, s, d, mesh2, ray_axis="rays"),
                      windows=3, inner=1)
        rows[name] = dict(differ=differ, kernel=kernel, rejects=rejects, peak=peak, ms=ms,
                          hits=int(ok.sum()))
        print(f"[n] patch-sharded intersect on a 1 x 1 ('rays', 'patches') mesh, {R} x "
              f"{p.num_patches} ({name}): launches {launches}; {differ} of {R} rays with "
              f"another winner than intersect_rays ({kernel}), recompute rejects on 4096 "
              f"rays {rejects}; peak memory {peak / 2**30:.3f} GiB", flush=True)
        del hit, want
    # padding rows: no candidate for rays from the origin, K3 bit-equal to
    # its twin on the padded table
    padded = pad_patches(patches, 4)
    s0, d0 = cone[0][:65536], cone[1][:65536]
    code, dist_ = cc.sweep_codes_cuda(padded, s0, d0)
    code_r, dist_r = cc.sweep_codes_reference(padded, s0, d0)
    torch.cuda.synchronize()
    inter = (code_r & 7) == ix.WHAT_INTERSECT
    assert padded.num_patches == 452 and torch.equal(code, code_r)
    assert torch.equal(dist_[inter], dist_r[inter]) and int(inter.sum()) > 10000
    assert bool(((code[:, patches.num_patches:] & 7) == ix.WHAT_NONE).all())
    print(f"[n] K3 on the robot padded to 452 rows, 65,536 cone rays from the origin: codes "
          f"and cIntersect distances bit-equal to the twin, no candidate on a padding row",
          flush=True)
    del code, dist_, code_r, dist_r, inter

    # the ('rays', 'patches') train step through refract_rays(intersect_fn=)
    step = sharding.make_sharded_train_step(mesh2, screen, zero, resolution=128,
                                            learning_rate=2.5e-7, patch_axis="patches")
    params, pp_losses = lens_model.params_from_scene(scene), []

    def three_steps():
        nonlocal params
        for _ in range(3):
            params, loss = step(params, start, direction)
            pp_losses.append(float(loss))

    _, pp_launches = cuda_lib.counted(three_steps)
    assert pp_launches == {"sweep_select": 0, "winner": 0, "sweep_codes": 6,
                           "fma_chains": 0, "tables": 6, "pack_rays": 6,
                           "segment_sum": 6, "recompute_forward": 6,
                           "recompute_backward": 6, "emitter": 0}, pp_launches
    assert np.isfinite(pp_losses).all() and pp_losses[2] < pp_losses[0], pp_losses
    fixed = sharding.make_sharded_train_step(mesh2, screen, zero, resolution=128,
                                             learning_rate=0.0, patch_axis="patches")
    p_fixed = lens_model.params_from_scene(scene)
    k1_step_ms = _fixed_step_ms(lens_model, scene)
    pp_step_ms = _time_ms(lambda: fixed(p_fixed, start, direction), windows=5, inner=1)
    k1_again_ms = _fixed_step_ms(lens_model, scene)

    fn, args = entry.entry(device=dev)
    with torch.no_grad():
        e_img = fn(*args)
    dry = entry.dryrun_multichip(1, device=dev)
    torch.cuda.synchronize()
    assert e_img.shape == (32, 32) and torch.isfinite(e_img).all() and float(e_img.sum()) > 10
    assert np.isfinite(dry)
    print(f"[n] one-rank NCCL group: render_multihost, render_multihost_ortho(512^2) and "
          f"render_multihost_emitter torch.equal to the single-process renders (max |d| "
          f"{gaps}); 3 SGD steps each (loss, first-step max |d grad cp| vs "
          f"make_train_step's, max |grad cp|): {steps_out}; ('rays', 'patches') step "
          f"through refract_rays(intersect_fn=): loss {pp_losses}, launches {pp_launches}; "
          f"entry() image sum {float(e_img.sum()):.3f}; dryrun_multichip(1) loss {dry!r}",
          flush=True)
    print(f"[n] {card} | patch-sharded intersect {R} x 450 {rows['robot']['ms']:.3f} ms, x "
          f"1800 {rows['refined']['ms']:.3f} ms; fixed-lens train step at the headline: "
          f"patch-sharded (K3) {pp_step_ms:.3f} ms, on K1 {k1_step_ms:.3f} and "
          f"{k1_again_ms:.3f} ms (before and after)", flush=True)
    return {"rows": rows, "launches": pp_launches, "pp_step_ms": pp_step_ms,
            "k1_step_ms": (k1_step_ms, k1_again_ms)}


def _host() -> str:
    """The host's CPU model (lscpu's), architecture and core count: the
    machine of the host-only times (the native build, preprocessing, the
    oracle)."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        out = ""
    model = next((line.split(":", 1)[1].strip() for line in out.splitlines()
                  if line.startswith("Model name")), "no model name")
    return f"{model} ({platform.machine()}), {os.cpu_count()} cores"


def _follow_keys(triples, num_patches: int):
    """One int64 key a follow triple (ray, patch, side, neighbour): the
    neighbour follows from the patch and the side."""
    return (triples[:, 0] * num_patches + triples[:, 1]) * 3 + triples[:, 2]


def _drivers_phase(dev, card, scene):
    """Phase o: the native runtime against the NumPy path, followers_report
    on K3 at the headline against the twin's and the unculled sweep's
    follow triples, BASELINE config 1 against the f64 oracle on a ray
    sample, the dense path against K1, and the drivers.  Returns a dict of
    what it measured."""
    import tempfile

    import numpy as np
    import torch

    from cbtr_tpu_torch import native
    from cbtr_tpu_torch.harness import drivers, preprocess
    from cbtr_tpu_torch.harness import reference_tracer as rt
    from cbtr_tpu_torch.mesh.core import TriMesh
    from cbtr_tpu_torch.models import scenes, sphere_lens_scene
    from cbtr_tpu_torch.ops import cuda_codes as cc
    from cbtr_tpu_torch.ops import cuda_lib
    from cbtr_tpu_torch.ops import intersect as ix
    from cbtr_tpu_torch.optics import REFRACT_INSIDE, REFRACT_OUTSIDE, refract_rays
    from cbtr_tpu_torch.render.render import render_lens_image, screen_hits

    host = _host()
    # the native runtime against the NumPy path (tests/test_native.py's bars)
    robot = TriMesh().read(scenes.robot_stl_path())
    mesh = preprocess(TriMesh(robot.tris.copy()))
    mesh.translate(-mesh.tris.reshape(-1, 3).mean(axis=0))
    mesh.scale(1.0 / float(np.abs(mesh.tris).max()))
    mesh = preprocess(mesh)
    mesh.split_triangles(6)
    pre_s = {}
    for name, tris in (("robot", robot.tris), ("split-6 robot", mesh.tris)):
        t = time.perf_counter()
        nt, nf, ns, na = native.preprocess(tris)
        native_s = time.perf_counter() - t
        t = time.perf_counter()
        ref = preprocess(TriMesh(tris.copy()), use_native=False).device_arrays()
        pre_s[name] = (native_s, time.perf_counter() - t)
        np.testing.assert_allclose(nt, ref["tris"], atol=1e-6)
        assert np.array_equal(nf, ref["fellow_triangles"]), name
        assert np.array_equal(ns, ref["fellow_common_side_starts"]), name
        np.testing.assert_allclose(na, ref["corner_average_normals"], atol=1e-5)
        gap = np.abs(na - ref["corner_average_normals"])
        print(f"[o] native preprocess vs NumPy, {name} ({len(tris)} faces): tris within "
              f"1e-6, topology equal, corner normals within 1e-5 ({int((gap > 0).sum())} of "
              f"{gap.size} entries differ, max {float(gap.max()):.3e})", flush=True)
    print(f"[o] host {host} | preprocess native vs NumPy: "
          + "; ".join(f"{k} {a:.4f} s vs {b:.4f} s" for k, (a, b) in pre_s.items()),
          flush=True)

    # followers_report at the headline through K3
    patches, start, direction = scene.patches, scene.start, scene.direction
    R, P = start.shape[0], patches.num_patches
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t = time.perf_counter()
    report, fr_launches = cuda_lib.counted(
        lambda: drivers.followers_report(patches, start, direction))
    fr_s = [time.perf_counter() - t]
    fr_peak = torch.cuda.max_memory_allocated(dev) - base
    assert fr_launches == {"sweep_select": 0, "winner": 0, "sweep_codes": 1,
                           "fma_chains": 0, "tables": 1, "pack_rays": 1,
                           "segment_sum": 0, "recompute_forward": 0,
                           "recompute_backward": 0, "emitter": 0}, fr_launches
    triples = report["triples"]
    assert len(report["followers"]) == R and report["total_follow_candidates"] == len(triples)
    assert len(triples) > 0 and (np.diff(triples[:, 0]) >= 0).all()
    for _ in range(2):
        t = time.perf_counter()
        drivers.followers_report(patches, start, direction)
        fr_s.append(time.perf_counter() - t)
    # the twin's codes and the unculled plain sweep's, 65,536 rays at a time
    chunk, nb = 65536, patches.neighbours
    twin, full = [], []
    with torch.no_grad():
        for r0 in range(0, R, chunk):
            s, d = start[r0:r0 + chunk], direction[r0:r0 + chunk]
            for acc, sweep in ((twin, cc.sweep_codes_reference), (full, ix.sweep_codes)):
                found = drivers.follow_triples(sweep(patches, s, d)[0], nb)
                found[:, 0] += r0
                acc.append(found)
    twin, full = np.concatenate(twin), np.concatenate(full)
    assert np.array_equal(triples, twin), (len(triples), len(twin))
    k3_keys, full_keys = _follow_keys(triples, P), _follow_keys(full, P)
    dropped = int(np.setdiff1d(full_keys, k3_keys).size)
    extra = int(np.setdiff1d(k3_keys, full_keys).size)
    assert extra == 0, extra
    print(f"[o] followers_report {R} x {P} on K3: {len(triples)} follow triples on "
          f"{report['rays_with_followers']} rays, identical to the report of the twin's "
          f"codes; the unculled plain sweep (intersect.sweep_codes) finds {len(full)}: the "
          f"cull drops {dropped}, adds {extra}; launches {fr_launches}", flush=True)
    print(f"[o] {card} | followers_report {R} x {P}: "
          f"{', '.join(f'{x:.3f}' for x in fr_s)} s (host clock, 3 calls; host {host}); "
          f"peak device memory above the scene {fr_peak / 2**30:.3f} GiB", flush=True)
    del report, twin, full

    # BASELINE config 1 against the f64 oracle on a seeded ray sample
    sph = sphere_lens_scene(res=128, sectors=15, belts=7, device=dev)
    n = sph.refractive_index

    def parity_forward():
        with torch.no_grad():
            s1, d1, st1 = refract_rays(sph.patches, n, sph.start, sph.direction,
                                       REFRACT_INSIDE)
            s2, d2, st2 = refract_rays(sph.patches, n, s1, d1, REFRACT_OUTSIDE)
            hit2d, on = screen_hits(s2, d2, sph.screen_plane)
            img = render_lens_image(sph.patches, n, sph.start, sph.direction,
                                    sph.screen_plane, extent=4.0, resolution=128)
        keep = (st1 == REFRACT_INSIDE) & (st2 == REFRACT_OUTSIDE) & on
        return hit2d.cpu().numpy(), keep.cpu().numpy(), img

    (hit2d, keep, img), par_launches = cuda_lib.counted(parity_forward)
    assert par_launches["sweep_select"] == 4 and par_launches["winner"] == 0, par_launches
    assert torch.isfinite(img).all() and float(img.sum()) > 1000.0
    idx = np.sort(np.random.default_rng(0).choice(len(keep), 1024, replace=False))
    t = time.perf_counter()
    ref2d, ref_keep = rt.oracle_screen_hits(
        rt.FastReferenceTracer(sph.patches), n, sph.screen_plane.cpu().numpy(),
        sph.start.cpu().numpy()[idx], sph.direction.cpu().numpy()[idx])
    oracle_s = time.perf_counter() - t
    masks, positions, pos_err = rt.landing_disagreement(hit2d[idx], keep[idx], ref2d, ref_keep)
    rate = (masks + positions) / len(idx)
    print(f"[o] BASELINE config 1 (sphere 15 x 7, P = {sph.patches.num_patches}, 128^2 rays, "
          f"K1 launches {par_launches['sweep_select']}) against FastReferenceTracer on 1024 "
          f"seeded rays: {int(ref_keep.sum())} kept by the oracle, {masks} kept by one side "
          f"only, {positions} landing > 5e-3 apart: disagreement {rate:.5f}; position error "
          f"median {float(np.median(pos_err)):.3e}, max {float(pos_err.max()):.3e}; image "
          f"sum {float(img.sum()):.3f}", flush=True)
    print(f"[o] host {host} | the oracle on 1024 rays, both refractions: {oracle_s:.2f} s",
          flush=True)
    assert ref_keep.sum() > 300 and rate <= 0.005 and np.median(pos_err) < 5e-4, \
        (masks, positions, float(np.median(pos_err)))
    del sph, img

    # the dense debug path against K1 on the first 4096 headline rays
    s4, d4 = start[:4096], direction[:4096]
    with torch.no_grad():
        dense = ix.select_best(*ix.candidates_with_retry(patches, patches, 0, s4, d4))
        k1 = ix.intersect_rays(patches, s4, d4)
        half = P // 2
        parts = [ix.candidates_with_retry(patches.row(torch.arange(lo, hi, device=dev)),
                                          patches, lo, s4, d4)
                 for lo, hi in ((0, half), (half, P))]
        sharded = ix.select_best(*(torch.cat(f, dim=1) for f in zip(*parts)))
    assert all(torch.equal(a, b) for a, b in zip(sharded, dense))
    differ = torch.nonzero((dense.what != k1.what) | (dense.patch != k1.patch))[:, 0].tolist()
    tracer = rt.ReferenceTracer(patches)
    sides = {"dense": 0, "K1": 0, "neither": 0}
    for r in differ:
        best = tracer.intersect(s4[r].double().cpu().numpy(), d4[r].double().cpu().numpy())
        want = -1 if best is None else best["patch"]
        side = ("dense" if want == int(dense.patch[r]) else
                "K1" if want == int(k1.patch[r]) else "neither")
        sides[side] += 1
    n_hits = int((dense.what == ix.WHAT_INTERSECT).sum())
    print(f"[o] dense path (candidates_with_retry + select_best, every patch) vs "
          f"intersect_rays on K1, first 4096 headline rays ({n_hits} dense hits): "
          f"{len(differ)} rays differ in what or patch; the scalar ReferenceTracer sides "
          f"with {sides}; the dense path over the table's two halves torch.equal to the "
          f"whole", flush=True)
    assert n_hits > 500 and len(differ) <= 4, (n_hits, differ)
    del dense, k1, parts, sharded

    # the drivers, their STLs read back
    with tempfile.TemporaryDirectory() as tmp:
        custom = drivers.custom_stl_driver(scenes.robot_stl_path(), 2, refine=True,
                                           out_dir=tmp, device=dev)
        tall = drivers.split_tall_driver(7, 3, (1.0, 4.0, 2.0), out_dir=tmp, device=dev)
        written = sorted(os.listdir(tmp))
        for name in written:
            back = TriMesh().read(os.path.join(tmp, name))
            assert len(back) > 0 and np.isfinite(back.tris).all(), name
        back = TriMesh().read(os.path.join(tmp, "refined_robot.stl"))
        np.testing.assert_allclose(back.tris, custom.refined_mesh.tris, rtol=5e-6, atol=1e-6)
    assert (custom.patches.num_patches, custom.refined_patches.num_patches) == (450, 1800)
    assert custom.num_thick > 0 and 0 < tall.num_thick1 and tall.num_thick2 <= tall.num_thick1
    print(f"[o] custom_stl_driver(robot, 2, refine=True) on the card: {custom.num_thick} "
          f"thick patches, refined P = {custom.refined_patches.num_patches}; "
          f"split_tall_driver: thick {tall.num_thick1} then {tall.num_thick2}; "
          f"{len(written)} STLs read back ({', '.join(written)})", flush=True)
    return {"launches": fr_launches, "triples": len(triples), "dropped": dropped,
            "followers_s": fr_s, "followers_peak": fr_peak, "parity": rate,
            "dense_differ": len(differ)}


def _scale_phase(dev, card):
    """Phase p: the artifact scripts' 4K paths at 16,777,216 rays, each
    driven through its script's entry point with its launches counted
    (`cuda_lib.counted`; render4k, train4k, emitter4k:
    warm-ups and repeats included; their records give the launches of one
    render or step), then the K1 and K2 time decomposition (cull_probe) and
    K1 at blocks of 16 and 32.
    Returns a dict of what it measured."""
    import torch

    from cbtr_tpu_torch.benchmarks import cull_probe, emitter4k, render4k, train4k
    from cbtr_tpu_torch.models import robot_lens_scene, scene_ortho_grid
    from cbtr_tpu_torch.ops import cuda_lib
    from cbtr_tpu_torch.ops import cuda_sweep as cs
    from cbtr_tpu_torch.parallel.multihost import (
        multihost_mesh,
        render_multihost_emitter,
        render_multihost_ortho,
    )

    n = 4096 * 4096
    path_launches = {}
    t = time.perf_counter()
    render, path_launches["render4k"] = cuda_lib.counted(lambda: render4k.run_gpu(device=dev))
    assert render["rays"] == n and render["image_sum"] > 0, render
    # the scatter splat is a fixed-order segment sum: two renders are equal
    assert render["deterministic"] and render["image_max_abs_diff_between_calls_rel"] == 0.0, \
        render
    print(f"[p] {card} | render4k: {n} rays -> 1024^2 image, chunk {render['chunk']}: "
          f"{render['wall_s']} s ({render['rays_per_s']} rays/s), peak "
          f"{render['peak_memory_gib']:.3f} GiB; checksum {render['image_checksum']}; two "
          f"calls equal: {render['deterministic']} "
          f"(max |d| / max {render['image_max_abs_diff_between_calls_rel']:.3e}); row-major "
          f"{render['row_major']['wall_s']} s, max |d| / max "
          f"{render['row_major']['image_max_abs_diff_rel']:.3e}; launches a render "
          f"{render['launches_per_render']}, in the script {path_launches['render4k']}",
          flush=True)

    train, path_launches["train4k"] = cuda_lib.counted(lambda: train4k.run_gpu(device=dev))
    assert train["rays"] == n and train["grad_cp_norm"] > 0, train
    assert train["deterministic"] and train["grad_cp_max_abs_diff_between_calls_rel"] == 0.0 \
        and train["loss_diff_between_calls"] == 0.0, train
    print(f"[p] {card} | train4k: one fwd+bwd SGD step on {n} rays, 128^2 target, chunk "
          f"{train['chunk']}: {train['wall_s']} s ({train['rays_per_s_fwd_bwd']} rays/s "
          f"fwd+bwd), peak {train['peak_memory_gib']:.3f} GiB; loss {train['loss']!r}, "
          f"|grad cp| {train['grad_cp_norm']:.6e}, grad n {train['grad_n_refr']:.6e}; "
          f"checksum {train['loss_grads_checksum']}; two "
          f"steps equal: {train['deterministic']} (max |d grad cp| / max "
          f"{train['grad_cp_max_abs_diff_between_calls_rel']:.3e}); launches a step "
          f"{train['launches_per_step']}, in the script {path_launches['train4k']}",
          flush=True)

    em, path_launches["emitter4k"] = cuda_lib.counted(lambda: emitter4k.run(
        host_path_n=1 << 22, device=dev))
    assert em["flux_per_ray_agreement"] < emitter4k.FLUX_BAR, em
    assert em["train_step"]["grad_cp_norm"] > 0, em
    assert em["device_path"]["deterministic"] and em["train_step"]["deterministic"], em
    assert em["device_path"]["image_max_abs_diff_between_calls_rel"] == 0.0, em
    print(f"[p] {card} | emitter4k: {n} DeviceEmitter rays (64 belts, seed 7) -> 256^2: "
          f"{em['device_path']['wall_s']} s ({em['device_path']['rays_per_s']} rays/s), "
          f"peak {em['device_path']['peak_memory_gib']:.3f} GiB; host path (cut to "
          f"{em['host_path']['rays']} rays) {em['host_path']['wall_s']} s; flux per ray "
          f"agreement {em['flux_per_ray_agreement']}; train step {em['train_step']['wall_s']} "
          f"s, loss {em['train_step']['loss']!r}, peak "
          f"{em['train_step']['peak_memory_gib']:.3f} GiB; launches a render "
          f"{em['device_path']['launches_per_render']}, a step "
          f"{em['train_step']['launches_per_step']}, in the script "
          f"{path_launches['emitter4k']}", flush=True)
    # one K1 launch, one ray pack and one recompute forward a chunk, for
    # each of the two refractions, on tables built once; one segment sum a
    # render (the scatter splat) and, in a step, each chunk's recompute
    # backward and the segment sum of its row gradients (no checkpoint: the
    # kernel pair keeps no residuals, so the forward runs once a chunk)
    # and, where the rays are a DeviceEmitter's, one emitter launch a render
    # or step
    def one_pass(rays, chunk, step=False, synthesized=False):
        chunks = -(-rays // chunk)
        return {"sweep_select": 2 * chunks, "winner": 0, "sweep_codes": 0, "fma_chains": 0,
                "tables": 1, "pack_rays": 2 * chunks,
                "segment_sum": 1 + (2 * chunks if step else 0),
                "recompute_forward": 2 * chunks,
                "recompute_backward": 2 * chunks if step else 0, "emitter": int(synthesized)}

    chunk = render["chunk"]
    per_4k, per_4k_step = one_pass(n, chunk), one_pass(n, chunk, step=True)
    per_em = one_pass(n, chunk, synthesized=True)
    per_em_step = one_pass(n, chunk, step=True, synthesized=True)
    per_host = one_pass(em["host_path"]["rays"], em["chunk"])
    for launches, want in ((render["launches_per_render"], per_4k),
                           (train["launches_per_step"], per_4k_step),
                           (em["device_path"]["launches_per_render"], per_em),
                           (em["train_step"]["launches_per_step"], per_em_step),
                           (em["host_path"]["launches_per_render"], per_host)):
        assert launches == want, (launches, want)
    # the launches counted around each script: render4k renders three
    # times (warm-up, timed, row-major), train4k steps twice, emitter4k
    # renders three times on the device and twice on the host path and steps
    # twice
    want = {"render4k": {k: 3 * v for k, v in per_4k.items()},
            "train4k": {k: 2 * v for k, v in per_4k_step.items()},
            "emitter4k": {k: 3 * v + 2 * per_host[k] + 2 * per_em_step[k]
                          for k, v in per_em.items()}}
    assert path_launches == want, (path_launches, want)
    print(f"[p] the 4K paths took {time.perf_counter() - t:.1f} s; launches in each "
          f"script {path_launches}", flush=True)

    sc = robot_lens_scene(res=1, device=dev)
    mesh = multihost_mesh()
    renders = {
        "4096^2 grid": lambda: render_multihost_ortho(
            mesh, sc.patches, sc.refractive_index, scene_ortho_grid(4096), sc.screen_plane,
            resolution=1024, chunk_size=chunk),
        "emitter": lambda: render_multihost_emitter(
            mesh, sc.patches, sc.refractive_index, emitter4k.device_emitter(n),
            sc.screen_plane, resolution=256, chunk_size=chunk),
    }
    # every ray of both refractions of both 4K renders: K1 against the
    # unit-gated semantics it replaces (its twin, on the tiles that list a
    # block; a tile that lists none is a miss on both) and against K1 with
    # the cull open (every block listed and gated, every pair evaluated)
    t = time.perf_counter()
    every_ray = {}
    for label, render_fn in renders.items():
        every_ray[label] = _k1_every_chunk(cs, sc.patches, render_fn, label, -(-n // chunk))
        for refraction, row in enumerate(every_ray[label], 1):
            print(f"[p] {card} | K1 {label} refraction {refraction}: {row['rays']} rays in "
                  f"{row['chunks']} chunks, {row['twin_rays']} of them on tiles that list a "
                  f"block; against the unit-gated twin {row['differ_twin']} rays differ; "
                  f"against K1 with the cull open {row['differ_open']}; the unit gates "
                  f"admitted {row['admitted']} pairs, K1 evaluated {row['evaluated']} "
                  f"({row['evaluated'] / max(row['admitted'], 1):.4f} of them) + "
                  f"{row['retries']} retries", flush=True)
            assert row["rays"] == n and row["differ_twin"] == 0, (label, refraction, row)
    del sc
    torch.cuda.empty_cache()
    print(f"[p] K1 against the unit-gated twin on every ray took "
          f"{time.perf_counter() - t:.1f} s", flush=True)

    t = time.perf_counter()
    rows = cull_probe.decomposition_rows(dev)
    for row in rows:
        assert row["b_rays_differ_from_unculled_reference"] == 0, row
        assert row["c_rays_differ_from_wrapper"] == 0, row
        # K2's refined lens keeps one block a tile in (a): a patch whose
        # sphere (radius 7.3) reaches the rays' origins
        assert row["a_all_culled"]["pairs"] <= 0.01 * row["b_none_culled"]["pairs"], row
        assert row["b_none_culled"]["pass1_pairs"] == row["rays"] * row["patches"], row
        print(f"[p] {card} | decomposition {row['shape']}: (a) all culled "
              f"{row['a_all_culled']['ms']:.4f} ms, {row['a_all_culled']['pairs']} pairs; (b) "
              f"none culled {row['b_none_culled']['ms']:.4f} ms, "
              f"{row['b_none_culled']['pairs']} pairs; (c) as is {row['c_as_is']['ms']:.4f} "
              f"ms, {row['c_as_is']['pairs']} pairs; floor {row['floor_ms']:.4f} ms, "
              f"{row['ns_per_pair'] * 1e3:.3f} ps a pair, predicted (c) "
              f"{row['predicted_c_ms']:.4f} ms, measured / predicted "
              f"{row['measured_over_predicted']:.3f}; (b) against the unculled reference: "
              f"{row['b_rays_differ_from_unculled_reference']} rays differ; (c) against the "
              f"wrapper {row['c_rays_differ_from_wrapper']}, against the unculled reference "
              f"{row['c_rays_differ_from_unculled_reference']}", flush=True)
    blocks = cull_probe.block_size_rows(dev)
    for row in blocks:
        print(f"[p] K1 at blocks of 16 and 32, {row['shape']}: {row['rays_differ']} of "
              f"{row['rays']} rays differ ({row['hits_block16']} hits at 16); the unculled "
              f"reference sides with {row['unculled_reference_sides_with']}", flush=True)
    print(f"[p] decomposition and block size took {time.perf_counter() - t:.1f} s",
          flush=True)
    return {"render": render, "train": train, "emitter": em,
            "launches": path_launches, "decomposition": rows, "block_size": blocks,
            "k1_every_ray": every_ray}


def _reuse_phase(dev, card):
    """Phase v: K1's second pass with the first pass's answers as its prior
    (`intersect.WinnerPrior`, handed on by `trace_through_lens`) at the 4K
    beam's and the car-lamp fan's chunks (phase p's two renders): in each
    second-pass chunk K1 with the prior against K1 without it on every ray
    (winners and distances bit for bit), its reused tiles (`reuse_counts`)
    against the tiles of the prior with no live ray, and both timed in
    turns beside the first pass's K1; then each render's image, and the
    headline step's loss and gradients, with the prior and with K1 made to
    drop it, bit for bit.  Standalone: `import chip_smoke` and call
    `_reuse_phase(device, card)`.  Returns {render: row}."""
    import torch

    from cbtr_tpu_torch.benchmarks import emitter4k
    from cbtr_tpu_torch.harness.kernel_ab import time_ms
    from cbtr_tpu_torch.models import lens_model, robot_lens_scene, scene_ortho_grid
    from cbtr_tpu_torch.ops import cuda_sweep as cs
    from cbtr_tpu_torch.ops import intersect as ix
    from cbtr_tpu_torch.parallel.multihost import (
        multihost_mesh,
        render_multihost_emitter,
        render_multihost_ortho,
    )
    from cbtr_tpu_torch.utils import profiling

    n, chunk = 4096 * 4096, 1 << 20
    sc = robot_lens_scene(res=1, device=dev)
    mesh = multihost_mesh()
    renders = {
        "4096^2 grid": lambda: render_multihost_ortho(
            mesh, sc.patches, sc.refractive_index, scene_ortho_grid(4096), sc.screen_plane,
            resolution=1024, chunk_size=chunk),
        "emitter": lambda: render_multihost_emitter(
            mesh, sc.patches, sc.refractive_index, emitter4k.device_emitter(n),
            sc.screen_plane, resolution=256, chunk_size=chunk),
    }
    search, wrapper = ix._winner_chunk, cs.sweep_select

    def dropped(*args, prior=None, **kwargs):
        return wrapper(*args, **kwargs)

    def without_prior(fn):
        cs.sweep_select = dropped
        try:
            return fn()
        finally:
            cs.sweep_select = wrapper

    rows = {}
    for label, render_fn in renders.items():
        row = {"chunks": 0, "rays": 0, "differ": 0, "tiles": 0, "dead_tiles": 0,
               "reused": 0, "launched": 0, "k1_pass1_ms": 0.0, "k1_pass2_ms_with": 0.0,
               "k1_pass2_ms_without": 0.0}

        def check(p, start, direction, *args, **kwargs):
            prior, _ = ix._CHUNK_PRIOR.get()
            result = search(p, start, direction, *args, **kwargs)
            inputs = cs.prepare_inputs(p, start, direction, tables=kwargs.get("tables"))
            if prior is None:
                row["k1_pass1_ms"] += time_ms(lambda: cs.launch(inputs), windows=3, inner=1,
                                              warmup=1)
                return result
            R = start.shape[0]
            cs.reset_pair_counts()
            with profiling.counting():
                got = cs.launch(inputs, prior=prior)
            reused, launched = cs.reuse_counts()
            cs.reset_pair_counts()
            want = cs.launch(inputs)
            T = -(-R // cs.TILE_R)
            live = torch.zeros(T * cs.TILE_R, dtype=torch.bool, device=start.device)
            live[:R] = prior.live
            dead = int((~live.reshape(T, cs.TILE_R).any(dim=1)).sum())
            differ = int(((got.win[:R] != want.win[:R])
                          | (got.dist[:R].view(torch.int32) != want.dist[:R].view(torch.int32)))
                         .sum())
            assert differ == 0 and (reused, launched) == (dead, T), \
                (label, row["chunks"], differ, reused, launched, dead, T)
            ms = {True: [], False: []}
            for with_ in (True, False, False, True):
                ms[with_].append(time_ms(lambda: cs.launch(inputs, prior=prior if with_ else None),
                                         windows=3, inner=1, warmup=1))
            for key, value in (("chunks", 1), ("rays", R), ("differ", differ), ("tiles", T),
                               ("dead_tiles", dead), ("reused", reused),
                               ("launched", launched), ("k1_pass2_ms_with", min(ms[True])),
                               ("k1_pass2_ms_without", min(ms[False]))):
                row[key] += value
            return result

        ix._winner_chunk = check
        try:
            with torch.no_grad():
                render_fn()
        finally:
            ix._winner_chunk = search
        with torch.no_grad():
            image = render_fn()
            image_without = without_prior(render_fn)
        row["image_equal"] = bool(torch.equal(image, image_without))
        row["image_sum"] = float(image.sum())
        assert row["chunks"] == -(-n // chunk) and row["rays"] == n, (label, row)
        assert row["image_equal"] and row["image_sum"] > 0, (label, row)
        rows[label] = row
        print(f"[v] {card} | K1 pass 2 with the prior, {label}: {row['rays']} rays in "
              f"{row['chunks']} chunks, {row['differ']} rays differ from K1 without it; "
              f"tiles reused {row['reused']} of {row['launched']} "
              f"({row['reused'] / row['launched']:.4f}; dead by the first statuses "
              f"{row['dead_tiles']}); K1 a render: pass 1 {row['k1_pass1_ms']:.3f} ms, pass 2 "
              f"{row['k1_pass2_ms_with']:.3f} ms with the prior, "
              f"{row['k1_pass2_ms_without']:.3f} ms without; images equal: "
              f"{row['image_equal']}", flush=True)

    head = robot_lens_scene(res=512, device=dev)
    target = torch.rand((128, 128), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(26))

    def step():
        params = lens_model.params_from_scene(head)
        loss = lens_model.lens_loss(params, head.start, head.direction, head.screen_plane,
                                    target)
        loss.backward()
        return loss.detach(), params.control_points.grad, params.refractive_index.grad

    cs.reset_pair_counts()
    with profiling.counting():
        got = step()
    reused, launched = cs.reuse_counts()
    cs.reset_pair_counts()
    want = without_prior(step)
    equal = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
    print(f"[v] {card} | headline step (512^2 rays) with the prior against without: loss, "
          f"control-point and index gradients equal {equal}; tiles reused {reused} of "
          f"{launched}", flush=True)
    assert all(equal) and 0 < reused < launched, (equal, reused, launched)
    rows["headline step"] = {"equal": equal, "reused": reused, "launched": launched}
    del sc, head
    torch.cuda.empty_cache()
    return rows


# the shape of the main path's segment sum (the headline step's recompute
# backward), whose times go into the kernel line
_SEG_MAIN = "headline recompute 262,144 x 60 -> 450"
# the device work of the segment sum's grouping (the radix sort, its counters
# and the offsets of a multi-pass sort): `kernel_ab.device_kernels`' names
_SEG_GROUPING = ("Memset", "tile_histogram", "scan_digits", "tile_scatter", "segment_bounds")


def _segment_phase(dev, card, scene, win):
    """Phase s: the segment-sum kernel against its plain version on the card
    at the shapes the main path gives it and at the sort's edge shapes, with
    its time, device ops (their device time by kernel) and peak memory
    beside torch's `index_add_` (atomic, and in the deterministic mode), its
    plain version's and its bound.  win: K1's winners of the headline grid.
    Returns {shape: row}."""
    import torch

    from cbtr_tpu_torch.harness import kernel_ab
    from cbtr_tpu_torch.models import scene_ortho_grid
    from cbtr_tpu_torch.ops import cuda_segment as sg
    from cbtr_tpu_torch.ops import cuda_sweep as cs
    from cbtr_tpu_torch.parallel.multihost import multihost_mesh, render_multihost_ortho
    from cbtr_tpu_torch.render import render as rd

    patches, P, L = scene.patches, scene.patches.num_patches, sg.GROUP
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(n, c):
        return torch.randn((n, c), generator=gen, device=dev)

    # the recompute's gather backward: the rows of the headline grid's K1
    # winners (misses clamped to patch 0, as recompute_winner clamps), and
    # of the first 1,048,576-ray chunk of the 4096^2 grid
    grid = scene_ortho_grid(4096)
    s4, d4 = grid.rays_at(torch.arange(1 << 20, device=dev))
    win4 = cs.sweep_select(patches, s4, d4)[1]
    del s4, d4
    # the 4K splat: the pixel ids and contributions a 4K render hands it
    captured, real = [], rd.segment_sum

    def capture(ids, vals, n):
        captured.append((ids, vals, n))
        return real(ids, vals, n)

    rd.segment_sum = capture
    try:
        with torch.no_grad():
            render_multihost_ortho(multihost_mesh(), patches, scene.refractive_index, grid,
                                   scene.screen_plane, resolution=1024, chunk_size=1 << 20)
    finally:
        rd.segment_sum = real
    (splat_ids, splat_vals, pixels), = captured
    # edge shapes: empty segments, one of GROUP rows, GROUP + 1, GROUP^2 and
    # GROUP^2 + 1, shuffled together
    lengths = torch.tensor([0, 1, L, L + 1, L * L, 0, L * L + 1, 3])
    edge = torch.repeat_interleave(torch.arange(lengths.numel()), lengths)
    edge = edge[torch.randperm(edge.numel(), generator=torch.Generator().manual_seed(0))]
    win64 = win.clamp_min(0).to(torch.int64)
    n = win.numel()

    def ids_in(low, high):
        return torch.randint(low, high, (n,), generator=gen, device=dev)

    shapes = {
        _SEG_MAIN: (win64, normal(n, 60), P),
        "headline recompute, int32 ids": (win64.to(torch.int32), normal(n, 60), P),
        "4K chunk recompute 1,048,576 x 60 -> 450": (win4.clamp_min(0).to(torch.int64),
                                                     normal(win4.numel(), 60), P),
        "4K splat 67,108,864 x 1 -> 1024^2": (splat_ids, splat_vals, pixels),
        f"edge {edge.numel():,} x 60 -> 8": (edge.to(dev), normal(edge.numel(), 60), 8),
        f"edge {edge.numel():,} x 1 -> 8": (edge.to(dev), normal(edge.numel(), 1), 8),
        # two sort passes (14 bits), the split-6 lens's patch count
        "262,144 x 60 -> 16,200 (two passes)": (ids_in(0, 16200), normal(n, 60), 16200),
        # the one-digit limit: 2,048 keys (with the dropped rows' key) in one
        # pass of 11 bits, 2,049 in two
        "262,144 x 1 -> 2,047 (one pass)": (ids_in(-8, 2056).to(torch.int32), normal(n, 1), 2047),
        "262,144 x 1 -> 2,048 (two passes)": (ids_in(-8, 2056), normal(n, 1), 2048),
        "262,144 x 60 -> 2,048, int32 ids": (ids_in(0, 2048).to(torch.int32), normal(n, 60),
                                              2048),
        "all rows dropped 262,144 x 60 -> 450": (ids_in(450, 10000), normal(n, 60), P),
        # three passes (23 bits), the plan's widest sort
        "262,144 x 1 -> 5,000,000 (three passes)": (ids_in(-8, 5000008), normal(n, 1),
                                                    5000000),
        # sparse splats (two passes): most of 1024^2 segments empty, between
        # few keys far apart
        "262,144 x 1 -> 1024^2, 16 lit pixels": (ids_in(0, 16) * 65521 + 7, normal(n, 1),
                                                 1 << 20),
        "262,144 x 60 -> 1024^2, every row on one pixel": (
            torch.full((n,), (1 << 19) + 512, device=dev), normal(n, 60), 1 << 20),
    }
    del captured, win4
    rows = {}
    for name, (ids, vals, S) in shapes.items():
        got = sg.launch(ids, vals, S)
        torch.cuda.synchronize()
        t = time.perf_counter()
        want = sg.segment_sum_reference(ids, vals, S)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3
        assert got.shape == want.shape and torch.equal(got, want), (
            name, int((got != want).sum()))
        assert not torch.signbit(got[got == 0]).any(), name
        assert torch.equal(sg.launch(ids, vals, S), got), name
        counts = torch.bincount(ids.to(torch.int64).clamp(0, S), minlength=S + 1)[:S]
        big = ids.numel() >= 1 << 24
        windows, inner = (3, 1) if big else (7, 3)
        ms = _time_ms(lambda: sg.launch(ids, vals, S), windows=windows, inner=inner)
        ops, busy, per_kernel, sessions = kernel_ab.device_kernels(
            lambda: sg.launch(ids, vals, S), kernel_ab.SEGMENT_STAGES)
        grouping = sum(v for k, v in per_kernel.items() if k in _SEG_GROUPING)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        sg.launch(ids, vals, S)
        torch.cuda.synchronize()
        peak_gib = (torch.cuda.max_memory_allocated() - before) / 2**30
        clamped = ids.clamp(0, S - 1)
        atomic_ms = _time_ms(lambda: torch.zeros((S, vals.shape[1]), device=dev).index_add_(
            0, clamped, vals), windows=windows, inner=inner)
        with _deterministic(True):
            det_ms = _time_ms(lambda: torch.zeros((S, vals.shape[1]), device=dev).index_add_(
                0, clamped, vals), windows=windows, inner=inner)
        nbytes = ids.numel() * ids.element_size() + vals.numel() * 4 + S * vals.shape[1] * 4
        bound = _bound_ms(float(vals.numel()), float(nbytes))
        plan = sg._workspace_plan(ids.numel(), S, vals.shape[1])
        rows[name] = dict(ms=ms, plain_ms=plain_ms, atomic_ms=atomic_ms,
                          deterministic_ms=det_ms, bound=bound, max_err=0.0,
                          longest=int(counts.max()), rows=ids.numel(), levels=plan.levels,
                          passes=len(plan.widths), device_ops=ops, busy_ms=busy,
                          grouping_ms=grouping, kernels_ms=per_kernel, peak_gib=peak_gib,
                          profiler_sessions=sessions,
                          workspace_gib=plan.nbytes / 2**30)
        print(f"[s] segment_sum {name}: torch.equal to its plain version and to a second "
              f"call (no -0.0), longest segment {rows[name]['longest']} rows, "
              f"{len(plan.widths)} sort passes of {plan.widths} bits, {plan.levels} levels, "
              f"{ids.dtype} ids", flush=True)
        print(f"[s] {card} | segment_sum {name}: {ms:.4f} ms, {ops} device ops "
              f"({sessions} profiler sessions), busy {busy:.4f} ms ({grouping:.4f} of it the "
              f"grouping: "
              f"{json.dumps({k: round(v, 4) for k, v in per_kernel.items()})}); peak "
              f"{peak_gib:.3f} GiB above its inputs vs plain version {plain_ms:.3f} ms, "
              f"index_add_ {atomic_ms:.4f} ms (atomic), {det_ms:.4f} ms (torch's deterministic "
              f"mode); bound {bound[0]:.4f} ms ({bound[1]})", flush=True)
        del got, want, clamped
    assert rows[_SEG_MAIN]["device_ops"] <= 10, rows[_SEG_MAIN]
    del shapes, splat_ids, splat_vals
    torch.cuda.empty_cache()
    return rows


def _sweep_build(cs, ptxas: dict, build_log: str) -> dict:
    """Phase 0's line for every instantiation of K1-K3 (the mode, and K1's
    half_gate): ptxas's registers, stack, spills and shared memory
    (`cuda_lib.ptxas_summary` of the build's output; each instantiation of a
    source built now must have its registers) and, for K1 and K2, the CTAs
    an SM holds at the headline's and the refined lens's tables.  Returns
    {instantiation: numbers}."""
    for stem in ("sweep_select", "winner", "sweep_codes"):
        if f"== {stem}.cu" in build_log:
            names = [f"{stem}_kernel<{m}{h}>" for m in range(4)
                     for h in ((", false", ", true") if stem == "sweep_select" else ("",))]
            assert all("registers" in ptxas.get(n, {}) for n in names), (stem, sorted(ptxas))
    out = {name: row for name, row in ptxas.items()
           if name.startswith(("sweep_select_kernel<", "winner_kernel<", "sweep_codes_kernel<"))}
    for mode in range(4):
        for half in (False, True):
            name = f"sweep_select_kernel<{mode}, {'true' if half else 'false'}>"
            out.setdefault(name, {})["ctas_per_sm"] = cs.occupancy(
                "sweep_select", 512, mode, half)
        out.setdefault(f"winner_kernel<{mode}>", {})["ctas_per_sm"] = cs.occupancy(
            "winner", 1920, mode)
    for name, row in out.items():
        print(f"[0] {name}: {row}", flush=True)
    return out


def _recompute_build(ptxas: dict) -> dict:
    """Phase 0's line for each recompute kernel: ptxas's registers, stack
    frame, spills and shared memory (`cuda_lib.ptxas_summary` of the
    build's output) and the device's answer for the build
    (`cuda_recompute.attributes`: the registers, local and shared bytes, the
    blocks of a launch an SM holds and the occupancy that follows, of 64
    warps an SM).  Returns {kind: numbers}, kind "forward" or "backward"."""
    from cbtr_tpu_torch.ops import cuda_recompute as cr

    out = {}
    for kind in ("forward", "backward"):
        name = f"recompute_{kind}_kernel"
        a = cr.attributes(kind == "backward")
        a["occupancy"] = a["threads"] * a["blocks_per_sm"] / 2048
        out[kind] = dict(ptxas=ptxas.get(name), **a)
        print(f"[0] {name}: ptxas {ptxas.get(name) or 'silent (built earlier)'}; the device: "
              f"{a['registers']} registers, {a['local_bytes']} local bytes, "
              f"{a['shared_bytes']} shared bytes, {a['threads']} threads x "
              f"{a['blocks_per_sm']} blocks an SM, occupancy {a['occupancy']:.3f}", flush=True)
    return out


# the shape of the main path's recompute (the headline step's), whose
# numbers go into the kernels line
_REC_MAIN = "headline 262,144 x 450 (K1's winners)"
_REC_FIELDS = ("what", "distance", "point", "normal", "bary", "cos_incidence", "patch",
               "what_w")
# what the recompute's arithmetic counts as f32 operations (aten names)
_F32_OPS = {"add", "sub", "mul", "div", "neg", "abs", "sqrt", "reciprocal", "maximum",
            "minimum", "clamp", "clamp_min", "clamp_max", "rsub"}


def _graph_phase(dev, card, scene):
    """Phase u: the fit step's CUDA graph against its eager body, its
    speed, and a captured 4K step's memory."""
    import torch

    from cbtr_tpu_torch.harness import step_graph
    from cbtr_tpu_torch.models import scenes

    out = {}
    for name, sc in (("headline", scene),
                     ("refined", scenes.robot_lens_scene(res=1024, refine=True, device=dev))):
        rec = step_graph.compare(sc, steps=6, after_restart=2)
        assert rec["equal"] and rec["counts"] == {"capture": 1, "replay": 4, "eager": 1} \
            and rec["counts_after_restart"] == {"capture": 0, "replay": 2, "eager": 1}, rec
        rec["ms"] = step_graph.step_ms(sc)
        out[name] = rec
        print(f"[u] {name} ({rec['rays']} x {rec['patches']}): replayed and eager steps "
              f"equal {rec['equal']} (max rel gap {rec['max_rel_gap']:.3e}), paths "
              f"{rec['paths']}, counts {rec['counts']} then {rec['counts_after_restart']}, "
              f"peak {rec['peak_gib']:.3f} GiB", flush=True)
        print(f"[u] {card} | {name} Adam step, ms (eager, graphed, graphed, eager turns): "
              f"{rec['ms']}", flush=True)
        del sc
        torch.cuda.empty_cache()
    big = scenes.robot_lens_scene(res=4096, device=dev)
    out["4k"] = step_graph.graphed_peak(big, chunk_size=1_048_576)
    print(f"[u] {card} | 4K Adam step captured: {out['4k']}", flush=True)
    del big
    torch.cuda.empty_cache()
    return out


def _ops_per_ray():
    """(forward, backward) f32 operations a ray of the recompute kernels: the
    elementwise f32 arithmetic of their plain versions, which evaluate the
    kernels' expressions one for one (every lane runs every one), counted
    under a dispatch mode on the CPU at 16^2 rays."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from cbtr_tpu_torch.models import robot_lens_scene
    from cbtr_tpu_torch.ops import cuda_recompute as cr
    from cbtr_tpu_torch.ops import cuda_sweep as cs

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (func.__name__.split(".")[0].rstrip("_") in _F32_OPS
                    and isinstance(out, torch.Tensor) and out.dtype == torch.float32):
                self.n += out.numel()
            return out

    sc = robot_lens_scene(res=16, device="cpu")
    any_hit, win, _ = cs.sweep_select(sc.patches, sc.start, sc.direction)
    R = sc.start.shape[0]
    args = (sc.patches.packed_f32().detach(), win.clamp_min(0).to(torch.int64), sc.start,
            sc.direction, any_hit)
    with Count() as fwd:
        cr.recompute_forward_reference(*args, win)
    cot = [torch.zeros(shape) for shape in ((R,), (R, 3), (R, 3), (R, 3), (R,))]
    with Count() as bwd:
        cr.recompute_adjoint_reference(*args, *cot)
    return fwd.n / R, bwd.n / R


def _kernel_only_ms(fn, name, calls=20, tries=3):
    """(device ms a call of kernel `name`, profiler sessions) over one
    session of `calls` calls of fn (`kernel_ab.device_kernels`), taken only
    when the session saw every call's launch: a short call's records can
    go missing (PERF.md §7)."""
    from cbtr_tpu_torch.harness import kernel_ab

    seen = []
    for _ in range(tries):
        ops, _, per, sessions = kernel_ab.device_kernels(lambda: [fn() for _ in range(calls)],
                                                         (name,))
        if ops == calls:
            return per[name] / calls, sessions
        seen.append(ops)
    raise RuntimeError(f"torch.profiler saw {seen} device ops for {calls} launches of {name}")


def _recompute_phase(dev, card, scene):
    """Phase r: the recompute kernels against their plain versions on the
    card at the main path's shapes (the headline on K1's winners, the
    refined robot on K2's, one 4K chunk on K1's): every forward field
    `torch.equal` to the twin's; the backward's row, start and direction
    gradients `torch.equal` to `recompute_adjoint_reference` (cotangents
    random on the hits and 0 on the misses, as the path gives them, and
    random on every ray), two runs bit-equal, and the gradients (the rows
    added by the segment-sum kernel, as `_Recompute` adds them) within
    tests/test_torch_recompute.py (a)'s bar of autograd through the twin;
    each kernel's time (CUDA events), its own device time (profiler kernel
    events), its plain version's, autograd's through the twin, the device
    ops of the recompute forward and of its forward and backward on the
    kernels, the peak memory above the inputs and the bound.  Returns
    {shape: row}."""
    import torch

    from cbtr_tpu_torch.harness import kernel_ab
    from cbtr_tpu_torch.models import scene_ortho_grid
    from cbtr_tpu_torch.ops import cuda_recompute as cr
    from cbtr_tpu_torch.ops import cuda_segment as sg
    from cbtr_tpu_torch.ops import cuda_sweep as cs
    from cbtr_tpu_torch.ops import cuda_winner as cw
    from cbtr_tpu_torch.ops import intersect as ix

    from cbtr_tpu_torch.models import robot_lens_scene

    fwd_ops, bwd_ops = _ops_per_ray()
    print(f"[r] f32 operations a ray (the plain versions' arithmetic, counted on the CPU): "
          f"forward {fwd_ops:.0f}, backward {bwd_ops:.0f}", flush=True)
    # the order in which the card's autograd sums a broadcast operand's three
    # terms (the backward kernel's rsum3, cuda_recompute._REDUCTION["cuda"])
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((1 << 20, 3), generator=gen, device=dev) * torch.exp(
        3 * torch.randn((1 << 20, 3), generator=gen, device=dev))
    y = torch.randn(1 << 20, generator=gen, device=dev).requires_grad_(True)
    g = torch.randn((1 << 20, 3), generator=gen, device=dev)
    (y[:, None] * x).backward(g)
    p0, p1, p2 = (g * x).unbind(1)
    orders = {"(a + b) + c": p0 + p1 + p2, "(a + c) + b": p0 + p2 + p1, "a + (b + c)": p0 + (p1 + p2)}
    differ = {k: int((v != y.grad).sum()) for k, v in orders.items()}
    print(f"[r] the card's autograd sums a [R, 3] product into [R, 1]: rows of 1,048,576 that "
          f"differ from each order {differ}", flush=True)
    assert differ["(a + c) + b"] == 0 and cr._REDUCTION["cuda"] == "ac_b", differ
    del x, y, g, p0, p1, p2, orders
    refined = robot_lens_scene(res=512, refine=True, device=dev)
    s4, d4 = scene_ortho_grid(4096).rays_at(torch.arange(1 << 20, device=dev))
    shapes = {
        _REC_MAIN: (scene.patches, scene.start, scene.direction, cs.sweep_select),
        "refined 262,144 x 1800 (K2's winners)": (refined.patches, refined.start,
                                                  refined.direction, cw.sweep_winner),
        "4K chunk 1,048,576 x 450 (K1's winners)": (scene.patches, s4, d4, cs.sweep_select),
    }

    def peak_above(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - before) / 2**30

    def wall_ms(fn):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    rows = {}
    for name, (patches, s, d, search) in shapes.items():
        s, d = s.contiguous(), d.contiguous()
        with torch.no_grad():
            any_hit, win, _ = search(patches, s, d)
        table = patches.packed_f32().detach().contiguous()
        idx = win.clamp_min(0).to(torch.int64)
        args = (table, idx, s, d, any_hit, win)
        R, P = s.shape[0], table.shape[0]
        got = cr.launch_forward(*args)
        want = cr.recompute_forward_reference(*args)
        torch.cuda.synchronize()
        differ = {f: int((g != w).sum()) for f, g, w in zip(_REC_FIELDS, got, want)}
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (name, differ)
        gen = torch.Generator(device=dev).manual_seed(13)
        every = [torch.randn(shape, generator=gen, device=dev)
                 for shape in ((R,), (R, 3), (R, 3), (R, 3), (R,))]
        hits = [torch.where(any_hit if c.dim() == 1 else any_hit[:, None], c, 0.0)
                for c in every]
        for label, cot in (("hits", hits), ("every ray", every)):
            first = cr.launch_backward(*args[:5], *cot)
            second = cr.launch_backward(*args[:5], *cot)
            plain = cr.recompute_adjoint_reference(*args[:5], *cot)
            torch.cuda.synchronize()
            assert all(torch.isfinite(g).all() for g in first), (name, label)
            assert all(torch.equal(a, b) for a, b in zip(first, second)), (name, label)
            assert all(torch.equal(a, b) for a, b in zip(first, plain)), (
                name, label, [int((a != b).sum()) for a, b in zip(first, plain)])
        # against autograd through the twin: the rows added by the segment-sum
        # kernel, as the Function adds them
        rows_g, g_s, g_d = cr.launch_backward(*args[:5], *hits)
        kernel_grads = (sg.launch(idx, rows_g, P), g_s, g_d)
        leaf_t = table.clone().requires_grad_(True)
        leaf_s, leaf_d = s.clone().requires_grad_(True), d.clone().requires_grad_(True)

        def twin_backward():
            hit, _ = cr.recompute_reference(leaf_t, idx, leaf_s, leaf_d, any_hit, win)
            sum(((torch.where(any_hit, hit.distance, 0.0) if f == "distance"
                  else getattr(hit, f)) * c).sum() for f, c in zip(_REC_FIELDS[1:6], hits)
                ).backward()

        twin_backward()
        bar = {}
        for label, a, b in zip(("table", "start", "direction"), kernel_grads,
                               (leaf_t.grad, leaf_s.grad, leaf_d.grad)):
            atol = 1e-5 * float(b.abs().max())
            outside = ~torch.isclose(a, b, rtol=1e-4, atol=atol)
            beyond = ~torch.isclose(a, b, rtol=1e-3, atol=atol)
            bar[label] = (int(outside.sum()), a.numel(), int(beyond.sum()),
                          int((a != b).sum()))
            assert float(outside.float().mean()) <= 5e-4 and not beyond.any(), (
                name, label, bar[label])

        ms_f = _time_ms(lambda: cr.launch_forward(*args))
        ms_b = _time_ms(lambda: cr.launch_backward(*args[:5], *hits))
        dev_f = _kernel_only_ms(lambda: cr.launch_forward(*args), "recompute_forward_kernel")
        dev_b = _kernel_only_ms(lambda: cr.launch_backward(*args[:5], *hits),
                                "recompute_backward_kernel")
        plain_f = wall_ms(lambda: cr.recompute_forward_reference(*args))
        plain_b = wall_ms(lambda: cr.recompute_adjoint_reference(*args[:5], *hits))

        def twin_step():
            for leaf in (leaf_t, leaf_s, leaf_d):
                leaf.grad = None
            twin_backward()

        twin_ms = wall_ms(twin_step)
        peak_f = peak_above(lambda: cr.launch_forward(*args))
        peak_b = peak_above(lambda: cr.launch_backward(*args[:5], *hits))

        # the main path's recompute on the kernels, forward alone and forward
        # with its backward (the twin's, about 1,100 and 3,900, are counted by
        # `kernel_ab --recompute-only` in a process of its own: a long
        # profiler session here would cost later short ones their records)
        def path(grad):
            if not grad:
                with torch.no_grad():
                    return ix.recompute_winner(patches, s, d, any_hit, win)
            p = patches.map(lambda t: t.detach().requires_grad_(t.is_floating_point()))
            hit = ix.recompute_winner(p, s, d, any_hit, win)
            (hit.point * hits[1]).sum().backward()

        ops = {label: kernel_ab.device_kernels(lambda g=g: path(g))[0]
               for label, g in (("forward", False), ("forward and backward", True))}
        nbytes_f = R * (8 + 1 + 4 + 24 + 56) + P * 240
        nbytes_b = R * (8 + 1 + 24 + 44 + 264) + P * 240
        rows[name] = dict(
            rays=R, patches=P, hits=int(any_hit.sum()), max_err=0.0, bar=bar,
            forward=dict(ms=ms_f, kernel_ms=dev_f[0], profiler_sessions=dev_f[1],
                         plain_ms=plain_f, peak_gib=peak_f,
                         bound=_bound_ms(fwd_ops * R, nbytes_f)),
            backward=dict(ms=ms_b, kernel_ms=dev_b[0], profiler_sessions=dev_b[1],
                          plain_ms=plain_b, autograd_ms=twin_ms, peak_gib=peak_b,
                          bound=_bound_ms(bwd_ops * R, nbytes_b)),
            path_device_ops=ops)
        for kind in ("forward", "backward"):
            r = rows[name][kind]
            extra = (f", autograd through the twin (forward and backward) {r['autograd_ms']:.3f} "
                     f"ms" if kind == "backward" else "")
            print(f"[r] {card} | recompute {kind} {name}: {r['ms']:.4f} ms (CUDA events), "
                  f"kernel alone {r['kernel_ms']:.4f} ms (profiler kernel events, "
                  f"{r['profiler_sessions']} sessions), peak {r['peak_gib']:.4f} GiB above its "
                  f"inputs; plain version "
                  f"{r['plain_ms']:.3f} ms{extra}; bound {r['bound'][0]:.4f} ms "
                  f"({r['bound'][1]}), kernel / bound {r['kernel_ms'] / r['bound'][0]:.2f}",
                  flush=True)
        print(f"[r] recompute {name}: {int(any_hit.sum())} hits of {R}; every forward field "
              f"torch.equal to the twin's; the backward torch.equal to the adjoint (hits' "
              f"and every ray's cotangents) and to a second run; against autograd through "
              f"the twin (outside rtol 1e-4, entries, beyond rtol 1e-3, not bit-equal): "
              f"{bar}; device ops of recompute_winner {ops}", flush=True)
        del got, want, every, hits, plain, first, second, kernel_grads, leaf_t
        torch.cuda.empty_cache()
    del s4, d4, refined
    torch.cuda.empty_cache()
    # both kernels at every Newton count (1-8) at the headline, forward and
    # backward, against the plain versions at that count
    with torch.no_grad():
        any_hit, win, _ = cs.sweep_select(scene.patches, scene.start, scene.direction)
    args = (scene.patches.packed_f32().detach().contiguous(), win.clamp_min(0).to(torch.int64),
            scene.start.contiguous(), scene.direction.contiguous(), any_hit, win)
    R = args[1].shape[0]
    gen = torch.Generator(device=dev).manual_seed(14)
    cot = [torch.where(any_hit if len(shape) == 1 else any_hit[:, None],
                       torch.randn(shape, generator=gen, device=dev), 0.0)
           for shape in ((R,), (R, 3), (R, 3), (R, 3), (R,))]
    for n in range(1, cr._MAX_ITERS + 1):
        with cr.newton_iterations(n):
            got_f, want_f = cr.launch_forward(*args), cr.recompute_forward_reference(*args)
            got_b = cr.launch_backward(*args[:5], *cot)
            want_b = cr.recompute_adjoint_reference(*args[:5], *cot)
            torch.cuda.synchronize()
        differ = [int((g != w).sum()) for g, w in zip(got_f + got_b, want_f + want_b)]
        assert not any(differ), (n, differ)
    print(f"[r] recompute {_REC_MAIN}: both kernels torch.equal to the plain versions at "
          f"every Newton count (1-{cr._MAX_ITERS}), forward and backward", flush=True)
    return rows


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
        scene_ortho_grid,
        sphere_lens_scene,
    )
    from cbtr_tpu_torch import native
    from cbtr_tpu_torch.benchmarks import fma_peak as fp
    from cbtr_tpu_torch.harness import kernel_ab
    from cbtr_tpu_torch.harness.determinism import divergent_sites
    from cbtr_tpu_torch.ops.cuda_segment import gather_rows
    from cbtr_tpu_torch.ops import cuda_codes as cc
    from cbtr_tpu_torch.ops import cuda_lib
    from cbtr_tpu_torch.ops import cuda_sweep as cs
    from cbtr_tpu_torch.ops import cuda_tables as ct
    from cbtr_tpu_torch.ops import cuda_winner as cw
    from cbtr_tpu_torch.ops import intersect as ix

    # the splat is an f32 matrix product: TF32 would change the image
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = _card()
    table_lenses = {}       # name -> patches, for phase t
    t_script = time.perf_counter()

    # ---- 0: device, versions, kernel build -------------------------------
    t = time.perf_counter()
    build_log = cuda_lib.build_library()
    build_s = time.perf_counter() - t
    print(f"[0] card: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| python {sys.version.split()[0]} | K1 + K2 + K3 + K4 + tables + segment_sum + "
          f"recompute + emitter build (one nvcc per source, in parallel) {build_s:.3f} s",
          flush=True)
    for line in build_log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            print(f"[0] ptxas {line.strip()}", flush=True)
    print(f"[0] CTAs per SM: K1 {cs.occupancy('sweep_select', 512)} (P_pad 512), K2 "
          f"{cs.occupancy('winner', 1920)} (P_pad 1920), "
          f"{cs.occupancy('winner', 16256)} (P_pad 16,256)", flush=True)
    ptxas = cuda_lib.ptxas_summary(build_log)
    sweep_build = _sweep_build(cs, ptxas, build_log)
    rec_build = _recompute_build(ptxas)
    # the native preprocessing runtime, before any scene: every lens below
    # starts from the mesh the JAX package's default preprocess gives
    fresh = not os.path.exists(native.LIB_PATH)
    t = time.perf_counter()
    if not native.available():
        raise RuntimeError(f"the native preprocessing runtime did not build: "
                           f"{native.build_error()}")
    print(f"[0] native preprocessing runtime: g++ {' '.join(native.GXX_FLAGS)} "
          f"{'built and loaded' if fresh else 'up to date, loaded'} in "
          f"{time.perf_counter() - t:.3f} s ({native.LIB_PATH}; host {_host()})", flush=True)

    # ---- 1: scene ----------------------------------------------------------
    t = time.perf_counter()
    with _calls(native, "preprocess") as native_calls:
        scene = robot_lens_scene(res=512, device=dev)
    P, R = scene.patches.num_patches, scene.start.shape[0]
    assert (P, R) == (450, 262144), (P, R)
    assert native_calls[0] > 0, "the headline scene was not preprocessed natively"
    print(f"[1] scene: robot.stl lens, P = {P} patches, R = {R} rays "
          f"(built in {time.perf_counter() - t:.3f} s; {native_calls[0]} native "
          f"preprocess calls)", flush=True)
    patches, start, direction = scene.patches, scene.start, scene.direction
    table_lenses["robot"] = patches

    # ---- 2: K1 against its plain twin ------------------------------------
    got = cs.sweep_select(patches, start, direction)
    ref = cs.sweep_select_reference(patches, start, direction)
    k1_cmp = _compare(got, ref)
    k1_win = got[1]          # phase s: the recompute's rows at the headline
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
    img, launched = cuda_lib.counted(lambda: _render(scene))
    launched = launched["sweep_select"]
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
    losses, g_max, g_n, main_launches = _train(lens_model, scene, 2.5e-7)
    # the recompute's gather backward: one segment sum a refraction a step
    # the tables once a step (both refractions share them), one ray pack a pass
    assert main_launches == {"sweep_select": 6, "winner": 0, "sweep_codes": 0,
                             "fma_chains": 0, "tables": 3, "pack_rays": 6, "segment_sum": 6,
                             "recompute_forward": 6, "recompute_backward": 6, "emitter": 0,
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
    d_cp, d_n, g_max = _gradient_twice(params, scene, target)
    sites, nodes, differ = divergent_sites(lambda: _loss_fresh(params, scene, target))
    img_a, img_b = _render(scene), _render(scene)
    print(f"[6] the headline gradient twice at one lens: max |d grad cp| {d_cp:.3e}, "
          f"|d grad n| {d_n:.3e} (|grad cp| max {g_max:.4e}); backward probe: {differ} of "
          f"{nodes} nodes give other gradients in a second run, order-dependent sites "
          f"{sites}; two renders (the matmul splat) equal: {torch.equal(img_a, img_b)}",
          flush=True)
    # the recompute's row gather adds its backward with the fixed-order
    # segment sum, and the splat is a matrix product: nothing moves
    assert d_cp == 0.0 and d_n == 0.0 and differ == 0 and sites == [], (d_cp, d_n, sites)
    assert torch.equal(img_a, img_b)
    del img_a, img_b
    # the probe names an atomic accumulation on the card: torch.index_select's
    # backward (the recompute's gather before the segment sum) adds 262,144
    # rows into 4 with float atomics; gather_rows' backward does not
    gen = torch.Generator(device=dev).manual_seed(6)
    tbl = torch.randn((4, 60), device=dev, generator=gen, requires_grad=True)
    idx = torch.randint(0, 4, (R,), device=dev, generator=gen)
    w = torch.randn((R, 60), device=dev, generator=gen)
    atomic_sites = divergent_sites(lambda: (torch.index_select(tbl, 0, idx) * w).sum(), 3)[0]
    fixed_sites = divergent_sites(lambda: (gather_rows(tbl, idx) * w).sum(), 3)[0]
    print(f"[6] backward probe on {R} rows gathered from 4, three runs: index_select's "
          f"order-dependent sites {atomic_sites}, gather_rows' {fixed_sites}", flush=True)
    assert [name for _, name in atomic_sites] == ["IndexSelectBackward0"], atomic_sites
    assert fixed_sites == [], fixed_sites
    del tbl, idx, w

    # ---- a: refined robot, P = 1800: the large-P path on K2 ---------------
    t = time.perf_counter()
    refined = robot_lens_scene(res=512, refine=True, device=dev)
    rp, rs, rd = refined.patches, refined.start, refined.direction
    assert (rp.num_patches, rs.shape[0]) == (1800, 262144), rp.num_patches
    host_s = time.perf_counter() - t
    table_lenses["refined"] = rp
    _, routed = cuda_lib.counted(lambda: ix.intersect_rays(rp, rs[:4096], rd[:4096]))
    assert routed == {"sweep_select": 0, "winner": 1, "sweep_codes": 0,
                      "fma_chains": 0, "tables": 1, "pack_rays": 1, "segment_sum": 0,
                      "recompute_forward": 1, "recompute_backward": 0, "emitter": 0}, routed
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
    losses, g_max, g_n, large_launches = _train(lens_model, refined, 2.5e-7)
    assert large_launches == {"sweep_select": 0, "winner": 6, "sweep_codes": 0,
                              "fma_chains": 0, "tables": 3, "pack_rays": 6, "segment_sum": 6,
                              "recompute_forward": 6, "recompute_backward": 6, "emitter": 0,
                              "tile_block_lists": 0}, large_launches
    r_dcp, r_dn, r_gmax = _gradient_twice(lens_model.params_from_scene(refined), refined,
                                          target)
    print(f"[a] render on K2 vs twin: max |d| {float((img - img_plain).abs().max()):.3e}; "
          f"train: 3 SGD steps, loss {losses}, |grad cp| max {g_max:.4e}, grad n "
          f"{g_n:.4e}, launches {large_launches}; the gradient twice at one lens: max |d "
          f"grad cp| {r_dcp:.3e}, |d grad n| {r_dn:.3e} (|grad cp| max {r_gmax:.4e})",
          flush=True)
    assert r_dcp == 0.0 and r_dn == 0.0, (r_dcp, r_dn)
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

    # ---- t: the table kernel and the ray pack against the plain versions ----------
    table_lenses["ellipsoid 15x5"] = ellipsoid_lens_scene(res=16, device=dev).patches
    assert len(table_lenses) == 7, sorted(table_lenses)
    tables_err, built = cuda_lib.counted(lambda: max(
        _check_tables(ct, name, lens) for name, lens in table_lenses.items()))
    assert built["tables"] == 3 * len(table_lenses), built
    print(f"[t] table kernel vs plain versions (patch table, bounds at block 16 and 32, "
          f"neighbours, K2's clamped at block 16; one workspace a build): torch.equal on "
          f"{', '.join(f'{n} (P = {q.num_patches})' for n, q in table_lenses.items())}",
          flush=True)
    grid4k = scene_ortho_grid(4096)
    rays_err, rays_rows = 0.0, {}
    for n in (262144, 1 << 20, 262144 - 37):
        gs4, gd4 = grid4k.rays_at(torch.arange(n, device=dev))
        got, want = ct.pack_rays(gs4, gd4), cs.pad_rays(gs4, gd4)
        torch.cuda.synchronize()
        assert got.shape == want.shape and torch.equal(got, want), n
        rays_err = max(rays_err, float((got - want).abs().max()))
        if n % cs.TILE_R == 0:
            # rays read once (24 bytes), the table written once (32 bytes a ray)
            rays_rows[n] = dict(
                ms=_time_ms(lambda: ct.pack_rays(gs4, gd4)),
                plain_ms=_time_ms(lambda: cs.pad_rays(gs4, gd4)),
                host_ms=kernel_ab.host_ms(lambda: ct.pack_rays(gs4, gd4)),
                device=kernel_ab._per_call(lambda: ct.pack_rays(gs4, gd4)),
                plain_device=kernel_ab._per_call(lambda: cs.pad_rays(gs4, gd4)),
                bound=_bound_ms(0.0, 24.0 * n + 4.0 * got.numel()),
                # inputs and output fit the 50 MB L2, where repeated calls
                # find them: the HBM bound does not hold the time
                l2_warm=24.0 * n + 4.0 * got.numel() < 50e6)
        del gs4, gd4, got, want
    print(f"[t] ray pack vs pad_rays: torch.equal at 262,144, 1,048,576 and 262,107 rays "
          f"(padded to 262,144)", flush=True)
    tables_ms, tables_plain_ms, tables_dev = {}, {}, {}
    for name in ("robot", "refined", "split-6"):
        lens = table_lenses[name]
        tables_ms[name] = _time_ms(lambda: ct.build_tables(lens, cs.BLOCK_P))
        tables_plain_ms[name] = _time_ms(lambda: ct.build_tables_reference(lens, cs.BLOCK_P))
        tables_dev[name] = {"host_ms": kernel_ab.host_ms(lambda: ct.build_tables(lens, cs.BLOCK_P)),
                            **kernel_ab._per_call(lambda: ct.build_tables(lens, cs.BLOCK_P))}
        assert tables_dev[name]["device_ops"] == 1, (name, tables_dev[name])
    # inputs read once (60 floats and 3 ids a patch), outputs written once;
    # about 190 operations a patch (27 adds, 3 divisions, 10 norms of 9, 60
    # min/max) and 13 a patch again in its block
    tables_out = ct.build_tables(patches, cs.BLOCK_P)
    tables_bound = _bound_ms(
        203.0 * P, sum(x.numel() * x.element_size()
                       for x in (*patches.leaves().values(), *tables_out)))
    k1_tables, k2_tables = ix.winner_tables(patches), ix.winner_tables(rp)
    prepare_ops = {
        "K1": kernel_ab._per_call(lambda: cs.prepare_inputs(patches, start, direction), 1),
        "K2": kernel_ab._per_call(lambda: cw.prepare_inputs(rp, rs, rd), 1),
        "K3": kernel_ab._per_call(
            lambda: cc.prepare_inputs(patches, start[:65536], direction[:65536]), 1),
        "K1 on its tables": kernel_ab._per_call(
            lambda: cs.prepare_inputs(patches, start, direction, tables=k1_tables), 1),
        "K2 on its tables": kernel_ab._per_call(
            lambda: cw.prepare_inputs(rp, rs, rd, tables=k2_tables), 1)}
    prepare_ms = _time_ms(lambda: cs.prepare_inputs(patches, start, direction))
    prepare_hoisted_ms = _time_ms(lambda: cs.prepare_inputs(patches, start, direction,
                                                            tables=k1_tables))
    for n, row in tables_dev.items():
        row["kernel_ms"] = row["kernels_ms"]["tables_kernel"]
    for row in rays_rows.values():
        row["kernel_ms"] = row["device"]["kernels_ms"]["pack_rays_kernel"]
    print(f"[t] {card} | table kernel at block 16 (CUDA events; its own device time by "
          f"torch.profiler; host time to issue it; the plain versions): " + ", ".join(
              f"{n} {tables_ms[n]:.4f} ms ({tables_dev[n]['kernel_ms']:.5f} ms kernel, "
              f"{tables_dev[n]['host_ms']:.4f} ms host; plain {tables_plain_ms[n]:.3f} ms)"
              for n in tables_ms) + f"; bound {tables_bound[0]:.6f} ms ({tables_bound[1]})",
          flush=True)
    print(f"[t] {card} | ray pack (the same columns; pad_rays' device ops and busy ms): "
          + ", ".join(f"{n} rays {r['ms']:.4f} ms ({r['kernel_ms']:.5f} ms kernel, "
                      f"{r['host_ms']:.4f} ms host, bound {r['bound'][0]:.5f} ms"
                      f"{', L2-warm' if r['l2_warm'] else ''}); pad_rays "
                      f"{r['plain_ms']:.4f} ms, {r['plain_device']['device_ops']:.0f} ops, "
                      f"{r['plain_device']['busy_ms']:.5f} ms busy"
                      for n, r in rays_rows.items()), flush=True)
    print(f"[t] {card} | prepare_inputs {R} x {P}: {prepare_ms:.4f} ms building its tables, "
          f"{prepare_hoisted_ms:.4f} ms on tables built once; device ops of one call: "
          f"{ {k: v['device_ops'] for k, v in prepare_ops.items()} }", flush=True)
    # a chunk on its lens's tables: the ray pack alone; building them: one more
    assert all(v["device_ops"] == 1 for k, v in prepare_ops.items() if "tables" in k), prepare_ops
    assert all(v["device_ops"] == 2 for k, v in prepare_ops.items() if "tables" not in k), \
        prepare_ops
    table_lenses_p = {n: lens.num_patches for n, lens in table_lenses.items()}
    del tables_out, table_lenses, k1_tables, k2_tables, grid4k

    # ---- r: the recompute kernels against their plain versions -------------------
    # before any long profiler session: a short call's records can go missing
    # after one (PERF.md §7)
    t = time.perf_counter()
    rec_rows = _recompute_phase(dev, card, scene)
    print(f"[r] took {time.perf_counter() - t:.1f} s", flush=True)

    # ---- f: K3 against its twin; the staged winners ----------------------------
    k3_rows = {}
    for name, sc in (("robot", scene), ("refined", refined)):
        p, s, d = sc.patches, sc.start[:65536], sc.direction[:65536]
        with _calls(cs, "tile_block_lists") as list_calls:
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
              f"gated_pairs) with the AABB leg, {sphere_listed:.4f} and {sphere_pairs} "
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

    # ---- q: the sweep's opt-in modes and K1's half gate ---------------------------
    t = time.perf_counter()
    mode_rows = _modes_phase(card, scene, refined, {
        "sweep_select": k1_bound[0], "winner": k2_bound[0],
        "sweep_codes": k3_rows["robot"]["bound"][0]})
    print(f"[q] took {time.perf_counter() - t:.1f} s", flush=True)

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


    # ---- j: the fit loop on the headline -------------------------------------
    import tempfile

    import numpy as np

    from cbtr_tpu_torch.models.fit import fit_emitter_lens, fit_lens
    from cbtr_tpu_torch.utils import checkpoint as ckpt

    torch.cuda.empty_cache()
    target = torch.zeros((128, 128), dtype=torch.float32, device=dev)
    sgd_lr, adam_lr = 2.5e-7, 1e-4     # phase 4's step size; Adam moves by lr
    with tempfile.TemporaryDirectory() as tmp:
        full = os.path.join(tmp, "full")
        (p_full, l_full), fit_launches = cuda_lib.counted(lambda: fit_lens(
            scene, target, 6, checkpoint_dir=full, checkpoint_every=2,
            learning_rate=sgd_lr))
        assert fit_launches == {"sweep_select": 12, "winner": 0, "sweep_codes": 0,
                                "fma_chains": 0, "tables": 6, "pack_rays": 12,
                                "segment_sum": 12, "recompute_forward": 12,
                                "recompute_backward": 12, "emitter": 0}, fit_launches
        assert l_full[-1] < l_full[0], l_full
        ckpts = sorted(os.listdir(full))
        assert ckpts == ["ckpt_2.npz", "ckpt_4.npz", "ckpt_6.npz"], ckpts
        # a killed fit resumed from its checkpoint, against the uninterrupted
        # one: in torch's default mode and in its deterministic mode, where
        # the two must land together in both
        resume = {}
        for mode in ("default", "deterministic"):
            with _deterministic(mode == "deterministic"):
                ref = (p_full, l_full) if mode == "default" else fit_lens(
                    scene, target, 6, learning_rate=sgd_lr)
                part = os.path.join(tmp, mode)
                p_3, _ = fit_lens(scene, target, 3, checkpoint_dir=part,
                                  checkpoint_every=2, learning_rate=sgd_lr)
                p_res, l_res = fit_lens(scene, target, 6, checkpoint_dir=part,
                                        checkpoint_every=2, learning_rate=sgd_lr)
                again = fit_lens(scene, target, 6, learning_rate=sgd_lr)
            assert len(l_res) == 3 and sorted(os.listdir(part)) == [
                "ckpt_2.npz", "ckpt_3.npz", "ckpt_4.npz", "ckpt_6.npz"]
            # the resumed fit starts exactly where the killed one stopped
            at_3, step = ckpt.load_params(os.path.join(part, "ckpt_3.npz"),
                                          scene.patches, dev)
            assert step == 3 and torch.equal(at_3.control_points, p_3.control_points)
            resume[mode] = {
                name: (float((p.control_points - ref[0].control_points).detach().abs().max()),
                       max(abs(a - b) / abs(b) for a, b in zip(losses[-3:], ref[1][3:])))
                for name, (p, losses) in (("resumed", (p_res, l_res)), ("again", again))}
        cp_max = float(p_full.control_points.detach().abs().max())
        d_cp, d_loss = resume["deterministic"]["resumed"]
        assert d_cp <= 1e-6 * cp_max and d_loss <= 1e-5, (resume, cp_max)
        # the default mode is reproducible too: the resumed fit and a second
        # uninterrupted one land on the first bit for bit
        assert resume["default"] == {"resumed": (0.0, 0.0), "again": (0.0, 0.0)}, resume
        loaded, step = ckpt.load_params(os.path.join(full, "ckpt_6.npz"), scene.patches,
                                         dev)
        with torch.no_grad():
            loss_loaded = float(lens_model.lens_loss(loaded, start, direction,
                                                     scene.screen_plane, target))
            loss_fit = float(lens_model.lens_loss(p_full, start, direction,
                                                  scene.screen_plane, target))
        assert step == 6 and torch.equal(loaded.control_points, p_full.control_points)
        assert abs(loss_loaded - loss_fit) <= 1e-6 * loss_fit, (loss_loaded, loss_fit)
    _, l_adam = fit_lens(scene, target, 3, learning_rate=adam_lr, optimizer="adam")
    assert l_adam[-1] < l_adam[0], l_adam
    fit_ms = {"sgd": _fit_step_ms(fit_lens, scene, target, None, sgd_lr),
              "adam": _fit_step_ms(fit_lens, scene, target, "adam", adam_lr)}
    with _deterministic(True):
        fit_ms["sgd_deterministic"] = _fit_step_ms(fit_lens, scene, target, None, sgd_lr)
    print(f"[j] fit_lens on the headline ({R} x {P}), 6 SGD steps at {sgd_lr}: loss "
          f"{l_full}, checkpoints {ckpts}, "
          f"launches {fit_launches}; resumed at 3 to 6 and run again, against the "
          f"uninterrupted fit, (max |d cp|, max |d loss| / loss) with max |cp| "
          f"{cp_max:.4f}: {resume}; ckpt_6 loaded: loss "
          f"{loss_loaded!r} vs the fit's {loss_fit!r}; 3 Adam steps at lr {adam_lr}: loss "
          f"{l_adam}", flush=True)
    print(f"[j] {card} | fit step {R} rays: SGD {fit_ms['sgd']:.3f} ms, Adam "
          f"{fit_ms['adam']:.3f} ms, SGD in torch's deterministic mode "
          f"{fit_ms['sgd_deterministic']:.3f} ms", flush=True)

    # ---- k: the large-P fit ---------------------------------------------------
    (_, l_big), big_launches = cuda_lib.counted(lambda: fit_lens(
        refined, target, 3, learning_rate=sgd_lr))
    assert big_launches == {"sweep_select": 0, "winner": 6, "sweep_codes": 0,
                            "fma_chains": 0, "tables": 3, "pack_rays": 6,
                            "segment_sum": 6, "recompute_forward": 6,
                            "recompute_backward": 6, "emitter": 0}, big_launches
    assert l_big[-1] < l_big[0], l_big
    big_ms = {"sgd": _fit_step_ms(fit_lens, refined, target, None, sgd_lr),
              "adam": _fit_step_ms(fit_lens, refined, target, "adam", adam_lr)}
    print(f"[k] fit_lens on the refined robot ({rs.shape[0]} x {rp.num_patches}), 3 SGD "
          f"steps: loss {l_big}, launches {big_launches}", flush=True)
    print(f"[k] {card} | fit step {rs.shape[0]} rays x {rp.num_patches} patches: SGD "
          f"{big_ms['sgd']:.3f} ms, Adam {big_ms['adam']:.3f} ms", flush=True)

    # ---- l: rays made on the device ---------------------------------------------
    from cbtr_tpu_torch.models import params_from_scene, scenes
    from cbtr_tpu_torch.models.fit import emitter_rays
    from cbtr_tpu_torch.render import camera
    from cbtr_tpu_torch.render import render as rd
    from cbtr_tpu_torch.render.emitters import DeviceEmitter, UniformHemisphere

    origin = tuple((scenes.LENS_CENTER - np.array([3.0, 0, 0], np.float32)).tolist())
    n_em = 262144
    em = DeviceEmitter(origin=origin, belts=16, n_rays=n_em, seed=1)
    idx = torch.arange(n_em, device=dev)
    for got, want in zip(em.bins_at(idx), em.bins_at(idx.cpu())):
        assert torch.equal(got.cpu(), want)
    es, ed, ew = em.rays_at(idx)
    es_c, ed_c, ew_c = em.rays_at(idx.cpu())
    em_dd = float((ed.cpu() - ed_c).abs().max())
    em_dw = float((ew.cpu() - ew_c).abs().max())
    assert torch.equal(es.cpu(), es_c) and em_dd <= 1e-6 and em_dw <= 1e-6, (em_dd, em_dw)
    em_sorted = _bin_sorted_fraction(ed, 16)
    em_wsum = float(ew.double().sum())
    assert em_sorted >= 0.995 and abs(em_wsum - n_em) <= 1e-3 * n_em, (em_sorted, em_wsum)
    del es_c, ed_c, ew_c

    def _emit_device():
        with torch.no_grad():
            return rd.render_emitter_image_device(patches, scene.refractive_index, em,
                                                  scene.screen_plane)

    def _emit_host():
        with torch.no_grad():
            return rd.render_emitter_image(patches, scene.refractive_index,
                                           UniformHemisphere(16, seed=1), n_em,
                                           np.asarray(origin, np.float32),
                                           scene.screen_plane)

    img_dev, em_launches = cuda_lib.counted(_emit_device)
    img_host = _emit_host()
    assert em_launches["sweep_select"] == 2 and em_launches["winner"] == 0 and \
        em_launches["emitter"] == 1, em_launches
    f_dev, f_host = float(img_dev.sum()), float(img_host.sum())
    flux_gap = abs(f_dev - f_host) / max(f_dev, f_host)
    assert torch.isfinite(img_dev).all() and f_dev > 0 and flux_gap < 0.12, (f_dev, f_host)
    em_ms = {"rays_at": _time_ms(lambda: em.rays_at(idx)),
             "device": _time_ms(_emit_device), "host": _time_ms(_emit_host)}
    print(f"[l] DeviceEmitter({n_em} rays, 16 belts, seed 1) on the card vs the CPU: u, "
          f"patch, j, cnt equal, max |d direction| {em_dd:.3e}, max |d weight| "
          f"{em_dw:.3e}; bin-sorted pairs {em_sorted:.6f}; sum w {em_wsum:.3f}; "
          f"render_emitter_image_device: flux {f_dev:.3f} vs host emitter's {f_host:.3f} "
          f"(gap {flux_gap:.4f}), launches {em_launches}", flush=True)
    print(f"[l] {card} | DeviceEmitter.rays_at {n_em} rays {em_ms['rays_at']:.3f} ms; "
          f"render_emitter_image_device {em_ms['device']:.3f} ms vs render_emitter_image "
          f"(host sampling, sort, upload) {em_ms['host']:.3f} ms", flush=True)
    del es, ed, ew, img_dev, img_host
    torch.cuda.empty_cache()
    emitter_out = _emitter_phase(dev, card)
    torch.cuda.empty_cache()

    es, ed = emitter_rays(n_em, belts=16, seed=1, origin=origin, device=dev)
    true = params_from_scene(scene)
    with torch.no_grad():
        em_target = lens_model.lens_forward(true, es, ed, scene.screen_plane)

    def perturbed():
        p = params_from_scene(scene)
        with torch.no_grad():
            p.control_points += torch.as_tensor(np.random.default_rng(0).normal(
                scale=2e-3, size=tuple(p.control_points.shape)).astype(np.float32), device=dev)
            p.refractive_index += 0.01
        return p

    def emitter_fit(learning_rate):
        return fit_emitter_lens(scene, em_target, 3, n_rays=n_em, belts=16, seed=1,
                                origin=origin, learning_rate=learning_rate,
                                init_params=perturbed())[1]

    # from this perturbed start the first step overshoots at 2.5e-4 and at
    # 1e-4 (0.1155 -> 0.1181; PERF.md §6); at 5e-5 each of five steps
    # fell in every run.  The two overshooting step sizes are printed, not
    # asserted; every fit runs twice and must repeat its losses exactly (the
    # backward's sums are fixed-order)
    emit_lr, l_over = 5e-5, {lr: emitter_fit(lr) for lr in (2.5e-4, 1e-4)}
    l_emit, emit_launches = cuda_lib.counted(lambda: emitter_fit(emit_lr))
    repeats = {lr: emitter_fit(lr) for lr in (emit_lr, 1e-4)}
    assert all(np.isfinite(l_emit)) and l_emit[-1] < l_emit[0], l_emit
    assert emit_launches["sweep_select"] == 6 and emit_launches["segment_sum"] == 6, \
        emit_launches
    assert emit_launches["recompute_forward"] == 6 and \
        emit_launches["recompute_backward"] == 6, emit_launches
    assert repeats == {emit_lr: l_emit, 1e-4: l_over[1e-4]}, (repeats, l_emit, l_over)
    print(f"[l] fit_emitter_lens on the robot, {n_em} emitter rays, 3 SGD steps at "
          f"{emit_lr} from a perturbed start: loss {l_emit}, launches {emit_launches}; "
          f"at 2.5e-4 and 1e-4: loss {l_over}; run again at {emit_lr} and 1e-4: the same "
          f"losses", flush=True)
    del es, ed, em_target

    grid = scene_ortho_grid(512)
    gs, gd = grid.rays_at(torch.arange(grid.n_rays, device=dev))
    assert torch.equal(gs, start) and torch.equal(gd, direction)
    with torch.no_grad():
        img_grid = rd.render_lens_image(patches, scene.refractive_index, gs, gd,
                                        scene.screen_plane)
    assert torch.equal(img_grid, _render(scene))
    big = scene_ortho_grid(4096)
    big_idx = torch.arange(big.n_rays, device=dev)
    host_args = ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                 scenes.ROBOT_BEAM_WIDTH, scenes.ROBOT_BEAM_WIDTH, 4096, 4096)

    def _host_grid():
        s_h, d_h = camera.ortho_ray_grid(*host_args)
        return torch.as_tensor(s_h).to(dev), torch.as_tensor(d_h).to(dev)

    big_dev, big_host = big.rays_at(big_idx), _host_grid()
    assert all(torch.equal(a, b) for a, b in zip(big_dev, big_host))
    del big_dev, big_host
    grid_ms = {"rays_at": _time_ms(lambda: big.rays_at(big_idx), windows=5, inner=1),
               "host": _time_ms(_host_grid, windows=3, inner=1, warmup=1)}
    print(f"[l] scene_ortho_grid(512).rays_at: torch.equal to the scene's rays, render "
          f"torch.equal to the host grid's image; at 4096^2 ({big.n_rays} rays) torch.equal "
          f"to the host grid", flush=True)
    print(f"[l] {card} | OrthoGrid.rays_at 4096^2 {grid_ms['rays_at']:.3f} ms vs host grid "
          f"+ upload {grid_ms['host']:.3f} ms", flush=True)
    del big_idx
    torch.cuda.empty_cache()

    (shade, depth, hit), normal_launches = cuda_lib.counted(lambda: rd.render_surface_normals(
        patches, start, direction, light_dir=(1.0, 0.0, 0.0)))
    plain = rd.render_surface_normals(patches, start, direction, (1.0, 0.0, 0.0),
                                      backend="plain")
    assert normal_launches["sweep_select"] == 1 and normal_launches["tables"] == 1, \
        normal_launches
    n_hits = int(hit.sum())
    assert torch.isfinite(shade).all() and n_hits > 1000 and torch.equal(hit, plain[2])
    torch.testing.assert_close(shade, plain[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(depth, plain[1], rtol=1e-5, atol=1e-5)
    print(f"[l] render_surface_normals {R} rays: {n_hits} hits, shade and depth vs the "
          f"plain twin max |d| {float((shade - plain[0]).abs().max()):.3e}, "
          f"{float((depth - plain[1]).abs().max()):.3e}; launches {normal_launches}",
          flush=True)
    del shade, depth, hit, plain

    # ---- m: mesh-vertex lens design ------------------------------------------------
    torch.cuda.empty_cache()
    t = time.perf_counter()
    design_out = _design_phase(dev, card)
    print(f"[m] took {time.perf_counter() - t:.1f} s", flush=True)

    # ---- n: the parallel layer on a one-rank NCCL group ----------------------------
    import datetime

    import torch.distributed as dist

    torch.cuda.empty_cache()
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'store')}",
                                world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=60))
        try:
            par_out = _parallel_phase(dev, card, scene, refined, em,
                                      design_out["cone"])
        finally:
            dist.destroy_process_group()
    print(f"[n] took {time.perf_counter() - t:.1f} s", flush=True)
    del design_out["cone"]

    # ---- o: native runtime, followers_report on K3, image parity, dense path, drivers ---
    torch.cuda.empty_cache()
    t = time.perf_counter()
    drivers_out = _drivers_phase(dev, card, scene)
    print(f"[o] took {time.perf_counter() - t:.1f} s", flush=True)

    # ---- p: the 4K paths, the K1/K2 decomposition, the block size -----------------
    torch.cuda.empty_cache()
    t = time.perf_counter()
    scale_out = _scale_phase(dev, card)
    print(f"[p] took {time.perf_counter() - t:.1f} s", flush=True)

    # ---- v: K1's second pass on the first pass's answers --------------------------
    torch.cuda.empty_cache()
    t = time.perf_counter()
    reuse_rows = _reuse_phase(dev, card)
    print(f"[v] took {time.perf_counter() - t:.1f} s", flush=True)

    # ---- s: the segment-sum kernel against its plain version ------------------------
    t = time.perf_counter()
    seg_rows = _segment_phase(dev, card, scene, k1_win)
    print(f"[s] took {time.perf_counter() - t:.1f} s", flush=True)
    del k1_win

    # ---- u: the fit step's CUDA graph -------------------------------------------------
    torch.cuda.empty_cache()
    t = time.perf_counter()
    _graph_phase(dev, card, scene)
    print(f"[u] took {time.perf_counter() - t:.1f} s", flush=True)

    # ---- r (the summary; the phase ran after phase t) --------------------------------
    # each path's recompute launches (counted around each path):
    # a forward and a backward a refraction a step, a forward a chunk a
    # refraction a render, and in a step a backward a chunk too (no chunk is
    # checkpointed on the kernels, so its forward runs once)
    rec_launches = {
        "train step": (main_launches, 3), "fit step": (fit_launches, 6),
        "refined step": (large_launches, 3),
        "design step": (design_out["launches"], design_out["steps"]),
        "4K render": (scale_out["render"]["launches_per_render"], 1),
        "4K step": (scale_out["train"]["launches_per_step"], 1),
        "emitter render": (scale_out["emitter"]["device_path"]["launches_per_render"], 1)}
    rec_launches = {k: (v["recompute_forward"] / n, v["recompute_backward"] / n)
                    for k, (v, n) in rec_launches.items()}
    print(f"[r] {card} | recompute kernel launches by path (forward, backward): "
          f"{rec_launches}", flush=True)
    assert rec_launches == {"train step": (2, 2), "fit step": (2, 2), "refined step": (2, 2),
                            "design step": (2, 2), "4K render": (32, 0), "4K step": (32, 32),
                            "emitter render": (32, 0)}, rec_launches

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

    # the table kernel's launches on every path (counted around each): once a lens a trace, whatever its chunks
    table_launches = {
        "train step": main_launches["tables"] / 3,
        "fit step": fit_launches["tables"] / 6,
        "refined step": large_launches["tables"] / 3,
        "design step": design_out["launches"]["tables"] / design_out["steps"],
        "4K render": scale_out["render"]["launches_per_render"]["tables"],
        "4K step": scale_out["train"]["launches_per_step"]["tables"],
        "emitter render": scale_out["emitter"]["device_path"]["launches_per_render"]["tables"],
        "followers_report": drivers_out["launches"]["tables"]}
    print(f"[t] {card} | table kernel launches by path: {table_launches}", flush=True)
    assert all(v == 1 for v in table_launches.values()), table_launches

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
            "launches_per_fit_step": fit_launches["sweep_select"] / 6,
            "launches_per_4k_render": scale_out["render"]["launches_per_render"]["sweep_select"],
            "launches_per_4k_step": scale_out["train"]["launches_per_step"]["sweep_select"],
            "launches_per_4k_emitter_render":
                scale_out["emitter"]["device_path"]["launches_per_render"]["sweep_select"],
            "launches_per_design_step":
                design_out["launches"]["sweep_select"] / design_out["steps"],
            "max_abs_err": k1_cmp[2],
            "ms": k1_ms,
            "plain_ms": k1_plain_ms,
            "bound_ms": k1_bound[0],
            "bound_by": k1_bound[1],
            "library_ms": None,
            "kernel_only_ms": k1_launch_ms,
            "second_pass_ms": k1_2_ms,
            "second_pass_bound_ms": k1_bound_2[0],
            "second_pass_prior": reuse_rows,
            "modes": mode_rows["sweep_select"],
            "build": {k: v for k, v in sweep_build.items() if k.startswith("sweep_select")},
        },
        {
            "name": "winner",
            "route": "cuda",
            "source": "cbtr_tpu_torch/csrc/winner.cu",
            "replaces": "cbtr_tpu/ops/pallas_sweep.py:1017",
            "launches": large_launches["winner"],
            "launches_per_step": large_launches["winner"] / 3,
            "launches_per_fit_step": big_launches["winner"] / 3,
            "launches_per_4k_render": scale_out["render"]["launches_per_render"]["winner"],
            "launches_per_4k_step": scale_out["train"]["launches_per_step"]["winner"],
            "launches_per_4k_emitter_render":
                scale_out["emitter"]["device_path"]["launches_per_render"]["winner"],
            "max_abs_err": k2_cmp[2],
            "ms": k2_ms,
            "plain_ms": k2_plain_ms,
            "bound_ms": k2_bound[0],
            "bound_by": k2_bound[1],
            "library_ms": None,
            "kernel_only_ms": k2_launch_ms,
            "modes": mode_rows["winner"],
            "build": {k: v for k, v in sweep_build.items() if k.startswith("winner")},
        },
        {
            "name": "sweep_codes",
            "route": "cuda",
            "source": "cbtr_tpu_torch/csrc/sweep_codes.cu",
            "replaces": "cbtr_tpu/ops/pallas_sweep.py:125",
            "launches": par_out["launches"]["sweep_codes"],
            "launches_per_step": par_out["launches"]["sweep_codes"] / 3,
            "launches_per_fit_step": fit_launches["sweep_codes"] / 6,
            "launches_per_4k_render": scale_out["render"]["launches_per_render"]["sweep_codes"],
            "launches_per_4k_step": scale_out["train"]["launches_per_step"]["sweep_codes"],
            "launches_per_4k_emitter_render":
                scale_out["emitter"]["device_path"]["launches_per_render"]["sweep_codes"],
            "launches_in_bench": bench_launches["sweep_codes"],
            "launches_in_followers_report": drivers_out["launches"]["sweep_codes"],
            "patch_sharded_step_ms": par_out["pp_step_ms"],
            "patch_sharded_intersect_ms": {k: v["ms"] for k, v in par_out["rows"].items()},
            "max_abs_err": max(r["max_err"] for r in k3_rows.values()),
            "ms": k3_rows["robot"]["tables"],
            "plain_ms": k3_rows["robot"]["plain"],
            "bound_ms": k3_rows["robot"]["bound"][0],
            "bound_by": k3_rows["robot"]["bound"][1],
            "library_ms": None,
            "kernel_only_ms": k3_rows["robot"]["alone"],
            "kernel_and_fill_ms": k3_rows["robot"]["fill"],
            "modes": mode_rows["sweep_codes"],
            "build": {k: v for k, v in sweep_build.items() if k.startswith("sweep_codes")},
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
            "launches_per_fit_step": fit_launches["tables"] / 6,
            "launches_per_4k_render": scale_out["render"]["launches_per_render"]["tables"],
            "launches_per_4k_step": scale_out["train"]["launches_per_step"]["tables"],
            "launches_per_4k_emitter_render":
                scale_out["emitter"]["device_path"]["launches_per_render"]["tables"],
            "launches_per_design_step":
                design_out["launches"]["tables"] / design_out["steps"],
            "launches_per_patch_sharded_step": par_out["launches"]["tables"] / 3,
            "launches_in_followers_report": drivers_out["launches"]["tables"],
            "launches_by_path": table_launches,
            "max_abs_err": tables_err,
            "ms": tables_ms["robot"],
            "plain_ms": tables_plain_ms["robot"],
            "bound_ms": tables_bound[0],
            "bound_by": tables_bound[1],
            "library_ms": None,
            "kernel_only_ms": tables_dev["robot"]["kernel_ms"],
            "host_ms": tables_dev["robot"]["host_ms"],
            "shapes": {n: {"patches": table_lenses_p[n], "ms": tables_ms[n],
                           "kernel_only_ms": tables_dev[n]["kernel_ms"],
                           "host_ms": tables_dev[n]["host_ms"],
                           "plain_ms": tables_plain_ms[n]} for n in tables_ms},
            "prepare_inputs_ms": prepare_ms,
            "prepare_inputs_on_tables_ms": prepare_hoisted_ms,
            "prepare_inputs_device_ops": {k: v["device_ops"] for k, v in prepare_ops.items()},
        },
        {
            "name": "pack_rays",
            "route": "cuda",
            "source": "cbtr_tpu_torch/csrc/tables.cu",
            "replaces": "cbtr_tpu/ops/pallas_sweep.py:810 rays.T (an XLA transpose, no "
                        "Pallas kernel)",
            "launches": main_launches["pack_rays"],
            "launches_per_step": main_launches["pack_rays"] / 3,
            "launches_per_fit_step": fit_launches["pack_rays"] / 6,
            "launches_per_4k_render": scale_out["render"]["launches_per_render"]["pack_rays"],
            "launches_per_4k_step": scale_out["train"]["launches_per_step"]["pack_rays"],
            "launches_per_4k_emitter_render":
                scale_out["emitter"]["device_path"]["launches_per_render"]["pack_rays"],
            "launches_per_design_step":
                design_out["launches"]["pack_rays"] / design_out["steps"],
            "max_abs_err": rays_err,
            # a 4K chunk's 58.7 MB outrun the 50 MB L2; the 262,144-ray row's
            # 14.7 MB stay there between calls, under the bound at the HBM rate
            "rays": 1 << 20,
            "ms": rays_rows[1 << 20]["ms"],
            "plain_ms": rays_rows[1 << 20]["plain_ms"],
            "bound_ms": rays_rows[1 << 20]["bound"][0],
            "bound_by": rays_rows[1 << 20]["bound"][1],
            "library_ms": None,
            "kernel_only_ms": rays_rows[1 << 20]["kernel_ms"],
            "host_ms": rays_rows[1 << 20]["host_ms"],
            "shapes": {n: {"ms": r["ms"], "kernel_only_ms": r["kernel_ms"],
                           "host_ms": r["host_ms"], "plain_ms": r["plain_ms"],
                           "plain_device_ops": r["plain_device"]["device_ops"],
                           "plain_busy_ms": r["plain_device"]["busy_ms"],
                           "bound_ms": r["bound"][0], "l2_warm": r["l2_warm"]}
                       for n, r in rays_rows.items()},
        },
        {
            "name": "segment_sum",
            "route": "cuda",
            "source": "cbtr_tpu_torch/csrc/segment_sum.cu",
            "replaces": "cbtr_tpu/ops/intersect.py:331 jnp.take's gradient and "
                        "cbtr_tpu/render/render.py:95 img.at[].add (XLA scatter-adds, no "
                        "Pallas kernel)",
            "launches": main_launches["segment_sum"],
            "launches_per_step": main_launches["segment_sum"] / 3,
            "launches_per_fit_step": fit_launches["segment_sum"] / 6,
            "launches_per_4k_render": scale_out["render"]["launches_per_render"]["segment_sum"],
            "launches_per_4k_step": scale_out["train"]["launches_per_step"]["segment_sum"],
            "launches_per_4k_emitter_render":
                scale_out["emitter"]["device_path"]["launches_per_render"]["segment_sum"],
            "launches_per_design_step":
                design_out["launches"]["segment_sum"] / design_out["steps"],
            "max_abs_err": max(r["max_err"] for r in seg_rows.values()),
            "ms": seg_rows[_SEG_MAIN]["ms"],
            "plain_ms": seg_rows[_SEG_MAIN]["plain_ms"],
            "bound_ms": seg_rows[_SEG_MAIN]["bound"][0],
            "bound_by": seg_rows[_SEG_MAIN]["bound"][1],
            "library_ms": seg_rows[_SEG_MAIN]["atomic_ms"],
            "library_deterministic_ms": seg_rows[_SEG_MAIN]["deterministic_ms"],
            "device_ops": seg_rows[_SEG_MAIN]["device_ops"],
            "shapes": {name: {k: r[k] for k in ("ms", "grouping_ms", "busy_ms", "device_ops",
                                                 "plain_ms", "atomic_ms", "deterministic_ms",
                                                 "longest", "passes", "levels", "peak_gib")}
                       | {"bound_ms": r["bound"][0]} for name, r in seg_rows.items()},
        },
        *({
            "name": f"recompute_{kind}",
            "route": "cuda",
            "source": "cbtr_tpu_torch/csrc/recompute.cu",
            "replaces": "cbtr_tpu/ops/intersect.py:314 (XLA fusion, no Pallas kernel)",
            "launches": main_launches[f"recompute_{kind}"],
            "launches_per_step": main_launches[f"recompute_{kind}"] / 3,
            "launches_per_fit_step": fit_launches[f"recompute_{kind}"] / 6,
            "launches_per_4k_render":
                scale_out["render"]["launches_per_render"][f"recompute_{kind}"],
            "launches_per_4k_step": scale_out["train"]["launches_per_step"][f"recompute_{kind}"],
            "launches_per_design_step":
                design_out["launches"][f"recompute_{kind}"] / design_out["steps"],
            "launches_by_path": {k: v[0 if kind == "forward" else 1]
                                 for k, v in rec_launches.items()},
            "max_abs_err": max(r["max_err"] for r in rec_rows.values()),
            "ms": rec_rows[_REC_MAIN][kind]["ms"],
            "plain_ms": rec_rows[_REC_MAIN][kind]["plain_ms"],
            "bound_ms": rec_rows[_REC_MAIN][kind]["bound"][0],
            "bound_by": rec_rows[_REC_MAIN][kind]["bound"][1],
            "library_ms": None,
            "kernel_only_ms": rec_rows[_REC_MAIN][kind]["kernel_ms"],
            "build": rec_build[kind],
            "shapes": {name: {k: r[kind][k] for k in ("ms", "kernel_ms", "plain_ms", "peak_gib")}
                       | {"bound_ms": r[kind]["bound"][0], "path_device_ops": r["path_device_ops"]}
                       for name, r in rec_rows.items()},
        } for kind in ("forward", "backward")),
        {
            "name": "fma_chains",
            "route": "cuda",
            "source": "cbtr_tpu_torch/csrc/fma_peak.cu",
            "replaces": "benchmarks/vpu_peak.py:48",
            "launches": bench_launches["fma_chains"],
            "launches_per_step": 0,
            "launches_per_fit_step": fit_launches["fma_chains"] / 6,
            "launches_per_4k_render": scale_out["render"]["launches_per_render"]["fma_chains"],
            "launches_per_4k_step": scale_out["train"]["launches_per_step"]["fma_chains"],
            "launches_per_4k_emitter_render":
                scale_out["emitter"]["device_path"]["launches_per_render"]["fma_chains"],
            "max_abs_err": k4_err,
            "ms": k4_ms[fp.N_BIG],
            "plain_ms": k4_plain_ms,
            "bound_ms": k4_bound[0],
            "bound_by": k4_bound[1],
            "library_ms": None,
        },
        {
            "name": "emitter",
            "route": "cuda",
            "source": "cbtr_tpu_torch/csrc/emitter.cu",
            "replaces": None,
            "launches_per_4k_emitter_render":
                scale_out["emitter"]["device_path"]["launches_per_render"]["emitter"],
            "rays": emitter_out["rays"],
            "ms": emitter_out["ms"]["events"],
            "kernel_only_ms": emitter_out["ms"]["kernel"],
            "plain_ms": emitter_out["ms"]["plain"],
            "bound_ms": emitter_out["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "differ": emitter_out["differ"],
            "direction_ulps": emitter_out["direction_ulps"],
            "peak_bytes": emitter_out["peak_bytes"],
        },
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

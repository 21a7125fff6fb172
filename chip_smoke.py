#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cbtr_tpu_torch) on one GPU.

Drives the port's main path -- the robot-lens irradiance render and its SGD
train step at the headline shape (robot.stl, 450 patches, 512x512 collimated
rays, 128x128 image, forward + backward) -- through the hand-written CUDA
kernel K1 (cbtr_tpu_torch/csrc/sweep_select.cu), and checks it:

  0  a CUDA device (exit 1 without one), the card, the versions, the build
  1  the scene, built by the port's own host stage
  2  K1 against its plain twin at the full shape, the lowest-id tie rule,
     and the no-fallback rule above the fused path's patch count
  3  the render on K1 and on the plain twin
  4  three SGD train steps (the main path; launch counts reset before it);
     the loss must fall
  5  timings: CUDA events, median of 7 windows after warm-up

One line per phase, then the kernel table as JSON, the card's name and
power limit, and last {"ok": true, "device": {...}}.  Any failure raises
and exits non-zero.  Run from the repository root:

    python3 chip_smoke.py
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _time_ms(fn, windows: int = 7, inner: int = 3, warmup: int = 2) -> float:
    """Median over `windows` of the mean time of `inner` calls (CUDA events)."""
    import torch

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's GPU path cannot run here",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cbtr_tpu_torch.models import lens_model, robot_lens_scene
    from cbtr_tpu_torch.ops import cuda_sweep as cs
    from cbtr_tpu_torch.ops import intersect as ix
    from cbtr_tpu_torch.render.render import render_lens_image

    # the splat is an f32 matrix product: TF32 would change the image
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = _card()

    # ---- 0: device, versions, kernel build -------------------------------
    t = time.perf_counter()
    cs.build_library()
    build_s = time.perf_counter() - t
    print(f"[0] card: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| python {sys.version.split()[0]} | K1 build {build_s:.3f} s", flush=True)

    # ---- 1: scene ----------------------------------------------------------
    t = time.perf_counter()
    scene = robot_lens_scene(res=512, device=dev)
    P, R = scene.patches.num_patches, scene.start.shape[0]
    assert (P, R) == (450, 262144), (P, R)
    print(f"[1] scene: robot.stl lens, P = {P} patches, R = {R} rays "
          f"(built in {time.perf_counter() - t:.3f} s)", flush=True)
    patches, start, direction = scene.patches, scene.start, scene.direction

    # ---- 2: K1 against its plain twin ------------------------------------
    got = cs.sweep_select(patches, start, direction)
    ref = cs.sweep_select_reference(patches, start, direction)
    torch.cuda.synchronize()
    hit_agree = float((got[0] == ref[0]).float().mean())
    both = got[0] & ref[0]
    win_agree = float((got[1] == ref[1])[both].float().mean())
    max_abs_err = float((got[2] - ref[2])[both].abs().max())
    _, rejects = ix.recompute_winner(patches, start, direction, got[0], got[1],
                                     with_check=True)
    print(f"[2] K1 vs twin at {R} x {P}: any_hit agreement {hit_agree:.6f}, "
          f"win agreement on {int(both.sum())} common hits {win_agree:.6f}, "
          f"max |d dist| {max_abs_err:.3e}, recompute rejects {rejects}", flush=True)
    assert hit_agree >= 0.999 and win_agree >= 0.999, (hit_agree, win_agree)
    # the build (no contraction, IEEE sqrt/div, one shared candidate routine)
    # makes K1 bit-identical to its twin: hold it to that
    assert hit_agree == 1.0 and win_agree == 1.0 and max_abs_err == 0.0, (
        hit_agree, win_agree, max_abs_err)
    assert int(both.sum()) > 10000 and rejects == 0

    # tie rule: a copy of a hit patch prepended as patch 0 ties it exactly
    w = int(got[1][both][0])
    ray = int(torch.nonzero(both & (got[1] == w))[0])
    leaves = {k: torch.cat([v[w:w + 1], v]) for k, v in patches.leaves().items()}
    leaves["neighbours"] = leaves["neighbours"] + 1
    tied = type(patches)(**leaves)
    t_hit, t_win, _ = cs.sweep_select(tied, start[ray:ray + 2], direction[ray:ray + 2])
    assert bool(t_hit[0]) and int(t_win[0]) == 0, (t_hit, t_win)
    # no fallback: above the fused path's patch count the GPU path raises
    big = type(patches)(**{k: torch.cat([v, v, v]) for k, v in patches.leaves().items()})
    try:
        ix.intersect_rays(big, start[:128], direction[:128])
    except NotImplementedError as exc:
        assert "K2" in str(exc)
    else:
        raise AssertionError("P > 1024 on the GPU did not raise")
    print(f"[2] tie: ray {ray} on patch {w} and its copy -> win {int(t_win[0])}; "
          f"P = {big.num_patches} raises NotImplementedError (K2)", flush=True)

    # ---- 3: render on K1 and on the plain twin ---------------------------
    before = cs.sweep_select.launches
    with torch.no_grad():
        img = render_lens_image(patches, scene.refractive_index, start, direction,
                                scene.screen_plane, resolution=128)
        launched = cs.sweep_select.launches - before
        img_plain = render_lens_image(patches, scene.refractive_index, start,
                                      direction, scene.screen_plane,
                                      resolution=128, backend="plain")
    torch.cuda.synchronize()
    assert launched == 2, launched
    assert torch.isfinite(img).all() and torch.isfinite(img_plain).all()
    assert float(img.sum()) > 1000.0
    torch.testing.assert_close(img, img_plain, rtol=1e-3, atol=1e-4)
    print(f"[3] render 512^2 rays -> 128^2 image: sum {float(img.sum()):.3f}, "
          f"max |K1 - plain| {float((img - img_plain).abs().max()):.3e}, "
          f"K1 launches {launched}", flush=True)

    # ---- 4: the main path: three SGD steps -------------------------------
    # The loss scales with the square of the rays per pixel, so the step size
    # is the one that descends at 64^2 rays (1e-3) scaled by (64/512)^4.
    target = torch.zeros((128, 128), dtype=torch.float32, device=dev)
    step = lens_model.make_train_step(scene.screen_plane, target, resolution=128,
                                      learning_rate=2.5e-7)
    params = lens_model.params_from_scene(scene)
    cs.sweep_select.launches = 0
    losses = []
    for _ in range(3):
        params, loss = step(params, start, direction)
        torch.cuda.synchronize()
        g = params.control_points.grad
        assert torch.isfinite(loss) and torch.isfinite(g).all()
        assert float(g.abs().max()) > 0 and torch.isfinite(params.refractive_index.grad)
        losses.append(float(loss))
    main_launches = cs.sweep_select.launches
    assert main_launches == 6, main_launches
    assert losses[2] < losses[0], losses
    print(f"[4] train: 3 SGD steps, loss {losses}, |grad cp| max "
          f"{float(g.abs().max()):.4e}, grad n {float(params.refractive_index.grad):.4e}, "
          f"K1 launches {main_launches}", flush=True)

    # ---- 5: timings --------------------------------------------------------
    inputs = cs.prepare_inputs(patches, start, direction)
    k1_launch_ms = _time_ms(lambda: cs.launch(inputs))
    k1_ms = _time_ms(lambda: cs.sweep_select(patches, start, direction))
    plain_ms = _time_ms(lambda: cs.sweep_select_reference(patches, start, direction),
                        windows=5, inner=1, warmup=1)
    with torch.no_grad():
        render_ms = _time_ms(lambda: render_lens_image(
            patches, scene.refractive_index, start, direction,
            scene.screen_plane, resolution=128))
    # a zero step size keeps every timed step on the same lens (same work)
    fixed_step = lens_model.make_train_step(scene.screen_plane, target,
                                            resolution=128, learning_rate=0.0)
    params = lens_model.params_from_scene(scene)
    step_ms = _time_ms(lambda: fixed_step(params, start, direction), windows=7, inner=2)
    listed = float(inputs.counts.sum()) / (inputs.counts.numel() * inputs.lists.shape[0])
    print(f"[5] {card} | K1 sweep+select {R} x {P}: {k1_ms:.3f} ms with its "
          f"tables ({k1_launch_ms:.3f} ms kernel alone, {listed:.4f} of tile x block "
          f"pairs listed) vs plain twin {plain_ms:.3f} ms", flush=True)
    print(f"[5] {card} | forward render {R} rays: {render_ms:.3f} ms "
          f"({R / render_ms * 1e3:.1f} rays/s)", flush=True)
    print(f"[5] {card} | train step fwd+bwd+SGD {R} rays: {step_ms:.3f} ms "
          f"({R / step_ms * 1e3:.1f} rays/s fwd+bwd)", flush=True)

    print(json.dumps({"kernels": [{
        "name": "sweep_select",
        "route": "cuda",
        "source": "cbtr_tpu_torch/csrc/sweep_select.cu",
        "replaces": "cbtr_tpu/ops/pallas_sweep.py:634",
        "launches": main_launches,
        "max_abs_err": max_abs_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "kernel_only_ms": k1_launch_ms,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

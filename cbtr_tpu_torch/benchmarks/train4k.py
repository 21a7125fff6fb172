"""A 4K train step: one forward + backward SGD step on 4096 x 4096 collimated
rays (16,777,216) through the robot lens.

Counterpart of benchmarks/train4k.py (the training half of BASELINE config
5).  Two halves:

* --gpu: one step of `parallel.multihost.make_multihost_train_step_ortho` on
  a group of one, rays made on the device, `intersect_rays` in chunks of
  --chunk (each chunk's recompute on the kernel pair, which keeps no
  residuals: no chunk is checkpointed, its backward re-runs the forward in
  registers), a 128^2 zero target at lr 1e-4.  The step runs twice
  from the same parameters (the first builds and warms); the record gives
  the second's wall time and rays/s, the loss, the control-point gradient's
  norm and the index's gradient, a checksum of the loss and gradients of
  each call (`deterministic`: equal, as they are in the default mode: the
  splat and the recompute's gather backward are fixed-order segment sums,
  `ops/cuda_segment.py`; the record also gives by how much two gradients
  differ), the kernels' launches a step, the chunk and the peak device
  memory; --deterministic runs the step under
  `torch.use_deterministic_algorithms(True)` as a cross-check;
* --procs N --res R: the same step over N processes (`multiprocess_render
  --train-ortho`), the post-step parameters bit-identical on every rank.

    python -m cbtr_tpu_torch.benchmarks.train4k --gpu [--res 4096]
        [--image-res 128] [--chunk N] [--deterministic] [--out FILE]
        [--device cuda|cpu]
    python -m cbtr_tpu_torch.benchmarks.train4k --procs 2 --res 64
"""
from __future__ import annotations

import argparse
import json

import torch

from ..ops import cuda_lib
from . import records
from .render4k import DEFAULT_CHUNK


def repeatable_step(step, params):
    """run() -> (loss, grad cp, grad n) of `step(params)`, the parameters put
    back after each call, so every call steps from the same lens."""
    cp0 = params.control_points.detach().clone()
    n0 = params.refractive_index.detach().clone()

    def run():
        _, loss, (g_cp, g_n) = step(params)
        out = (loss.detach(), g_cp.detach().clone(), g_n.detach().clone())
        with torch.no_grad():
            params.control_points.copy_(cp0)
            params.refractive_index.copy_(n0)
        return out

    return run


def run_gpu(res: int = 4096, image_res: int = 128, chunk: int = DEFAULT_CHUNK,
            device="cuda", scene=None, learning_rate: float = 1e-4,
            deterministic: bool = False) -> dict:
    """The --gpu half; returns its record.  scene as in `render4k.run_gpu`."""
    from ..models import params_from_scene, robot_lens_scene, scene_ortho_grid
    from ..parallel.multihost import make_multihost_train_step_ortho, multihost_mesh

    dev = records.resolve_device(device)
    scene = scene or robot_lens_scene(res=1, device=dev)
    grid = scene_ortho_grid(res)
    params = params_from_scene(scene)
    target = torch.zeros((image_res, image_res), dtype=torch.float32, device=dev)
    step = repeatable_step(make_multihost_train_step_ortho(
        multihost_mesh(), scene.screen_plane, target, grid, resolution=image_res,
        learning_rate=learning_rate, chunk_size=chunk), params)

    with records.deterministic(deterministic):
        records.reset_peak(dev)
        first = step()                                          # build + warm
        (second, dt), launches = cuda_lib.counted(lambda: records.wall_s(step, dev))
        peak = records.peak_gib(dev)
    loss, g_cp, g_n = first
    gnorm = float(torch.linalg.vector_norm(g_cp))
    assert torch.isfinite(loss) and gnorm > 0 and torch.isfinite(g_cp).all(), \
        (float(loss), gnorm)
    c1, c2 = records.checksum(*first), records.checksum(*second)
    return {
        "metric": f"sharded {res}x{res} robot TRAIN step (fwd+bwd) -> {image_res}^2 target",
        "rays": grid.n_rays,
        "wall_s": round(dt, 3),
        "rays_per_s_fwd_bwd": round(grid.n_rays / dt, 1),
        "loss": float(loss),
        "grad_cp_norm": gnorm,
        "grad_n_refr": float(g_n),
        "loss_grads_checksum": c1,
        "deterministic": c1 == c2,
        "grad_cp_max_abs_diff_between_calls_rel":
            float((second[1] - g_cp).abs().max()) / max(float(g_cp.abs().max()), 1e-30),
        "loss_diff_between_calls": float(second[0] - loss),
        "torch_deterministic_algorithms": deterministic,
        "chunk": chunk,
        "peak_memory_gib": peak,
        "launches_per_step": launches,
        **records.card_fields(dev),
    }


def run_procs(nproc: int, res: int, device: str = "cuda") -> dict:
    """Two ortho-ray SGD steps over `nproc` processes, every rank's post-step
    parameters bit-identical (`multiprocess_render.launch` asserts it)."""
    from . import multiprocess_render

    runs = multiprocess_render.launch(nproc, res=res, mode="train-ortho", device=device)
    return {"metric": f"{nproc}-process {res}x{res} ortho train step: bit-identical "
                      "post-step params", "procs": nproc, "res": res, "ranks_equal": True,
            "loss1": float(runs[0]["loss1"]), "loss2": float(runs[0]["loss2"]),
            **records.card_fields(torch.device(device)), "n_devices": nproc}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gpu", action="store_true", help="the 4K step on one device")
    ap.add_argument("--procs", type=int, default=0, help="the sharded step over N processes")
    ap.add_argument("--res", type=int, default=4096)
    ap.add_argument("--image-res", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=DEFAULT_CHUNK,
                    help="rays a chunk of intersect_rays (0: one chunk)")
    ap.add_argument("--deterministic", action="store_true",
                    help="under torch.use_deterministic_algorithms(True)")
    records.add_output_args(ap)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not (args.gpu or args.procs):
        ap.error("pass --gpu, --procs N or both")
    records.resolve_device(args.device)
    if args.procs:
        print(json.dumps(run_procs(args.procs, min(args.res, 64), args.device)), flush=True)
    if args.gpu:
        rec = run_gpu(args.res, args.image_res, args.chunk, args.device,
                      deterministic=args.deterministic)
        records.emit(rec, args.out, args.label)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

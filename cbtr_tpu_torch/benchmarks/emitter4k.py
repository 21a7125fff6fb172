"""A point-source render at scale: 16,777,216 emitter rays through the robot lens.

Counterpart of benchmarks/emitter4k.py, the emitter analogue of render4k.
`DeviceEmitter` makes the rays on the device, already sorted by the
reference's belt/patch bin (64 belts, seed 7, at LENS_CENTER - (3, 0, 0)),
and `parallel.multihost.render_multihost_emitter` renders them to a 256^2
image on a group of one.  The host path `render_emitter_image` samples
`UniformHemisphere` in NumPy, sorts by bin and uploads every call: the
stage `DeviceEmitter` removes.  --host-path-n cuts the host path's rays
(the record says so: `host_path.rays`, `host_path.cut`).  Then one
`make_multihost_train_step_emitter` step (fwd+bwd) toward the device
image, normalised, at lr 1e-4.

The record has the JAX record's keys (device and host paths, their
speed-up, the flux per ray of both, which estimate the same irradiance
integral, the train step) with the chunk, the peak device memory and the
kernels' launches; the script asserts that the two fluxes per ray agree to
2 %.

    python -m cbtr_tpu_torch.benchmarks.emitter4k [--n N] [--belts 64]
        [--image-res 256] [--host-path-n N] [--chunk N] [--out FILE]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import cuda_lib
from . import records
from .render4k import DEFAULT_CHUNK
from .train4k import repeatable_step

FLUX_BAR = 0.02
SEED = 7


def origin() -> tuple:
    """The point source: LENS_CENTER - (3, 0, 0)."""
    from ..models.scenes import LENS_CENTER

    return tuple((np.asarray(LENS_CENTER) - np.array([3.0, 0, 0], np.float32)).tolist())


def device_emitter(n: int = 4096 * 4096, belts: int = 64):
    """The device path's rays: a DeviceEmitter at `origin()`, seed SEED."""
    from ..render.emitters import DeviceEmitter

    return DeviceEmitter(origin=origin(), belts=belts, n_rays=n, seed=SEED)


def run(n: int = 4096 * 4096, belts: int = 64, image_res: int = 256, host_path_n: int = 0,
        chunk: int = DEFAULT_CHUNK, device="cuda", scene=None) -> dict:
    """Both paths and the train step; returns the record.  scene as in
    `render4k.run_gpu`."""
    from ..models import params_from_scene, robot_lens_scene
    from ..parallel.multihost import (
        make_multihost_train_step_emitter,
        multihost_mesh,
        render_multihost_emitter,
    )
    from ..render.emitters import UniformHemisphere
    from ..render.render import render_emitter_image

    dev = records.resolve_device(device)
    scene = scene or robot_lens_scene(res=1, device=dev)
    mesh = multihost_mesh()
    em = device_emitter(n, belts)

    def dev_render():
        with torch.no_grad():
            return render_multihost_emitter(mesh, scene.patches, scene.refractive_index, em,
                                            scene.screen_plane, resolution=image_res,
                                            chunk_size=chunk)

    n_host = host_path_n or n
    hemi = UniformHemisphere(belts=belts, seed=SEED)

    def host_render():
        with torch.no_grad():
            return render_emitter_image(scene.patches, scene.refractive_index, hemi, n_host,
                                        np.asarray(origin(), np.float32), scene.screen_plane,
                                        resolution=image_res, chunk_size=chunk)

    records.reset_peak(dev)
    dev_render()                                                # build + warm
    (img, dt_dev), render_launches = cuda_lib.counted(lambda: records.wall_s(dev_render, dev))
    peak_render = records.peak_gib(dev)
    img_again = dev_render()
    host_render()                                               # warm (fresh rays anyway)
    (img_h, dt_host), host_launches = cuda_lib.counted(lambda: records.wall_s(host_render, dev))

    params = params_from_scene(scene)
    target = img / torch.clamp_min(img.max(), 1.0)
    step = repeatable_step(make_multihost_train_step_emitter(
        mesh, scene.screen_plane, target, em, resolution=image_res, learning_rate=1e-4,
        chunk_size=chunk), params)
    records.reset_peak(dev)
    first_step = step()                                         # build + warm
    ((loss, g_cp, g_n), dt_train), step_launches = cuda_lib.counted(
        lambda: records.wall_s(step, dev))
    peak_step = records.peak_gib(dev)
    gn = float(torch.linalg.vector_norm(g_cp))
    assert torch.isfinite(loss) and np.isfinite(gn) and gn > 0, (float(loss), gn)
    assert bool(torch.isfinite(img).all()) and float(img.sum()) > 0, "empty or non-finite image"
    c1, c2 = records.checksum(img), records.checksum(img_again)
    flux_dev = float(img.sum()) / n
    flux_host = float(img_h.sum()) / n_host
    return {
        "metric": f"{n} point-source rays -> {image_res}^2 image, robot lens",
        "rays": n,
        "device_path": {
            "wall_s": round(dt_dev, 3),
            "rays_per_s": round(n / dt_dev, 1),
            "checksum": c1,
            "deterministic": c1 == c2,
            "image_max_abs_diff_between_calls_rel":
                float((img_again - img).abs().max()) / max(float(img.abs().max()), 1e-30),
            "peak_memory_gib": peak_render,
            "launches_per_render": render_launches,
        },
        "host_path": {
            "rays": n_host,
            "cut": n_host < n,
            "wall_s": round(dt_host, 3),
            "rays_per_s": round(n_host / dt_host, 1),
            "launches_per_render": host_launches,
        },
        "device_vs_host_speedup": round((n / dt_dev) / (n_host / dt_host), 2),
        "flux_per_ray_agreement": round(abs(flux_dev - flux_host) / max(flux_dev, flux_host), 4),
        "flux_per_ray": {"device_path": flux_dev, "host_path": flux_host},
        "train_step": {
            "wall_s": round(dt_train, 3),
            "rays_per_s_fwd_bwd": round(n / dt_train, 1),
            "loss": float(loss),
            "grad_cp_norm": round(gn, 6),
            "deterministic": records.checksum(*first_step) == records.checksum(loss, g_cp, g_n),
            "peak_memory_gib": peak_step,
            "launches_per_step": step_launches,
        },
        "belts": belts,
        "seed": SEED,
        "chunk": chunk,
        **records.card_fields(dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4096 * 4096)
    ap.add_argument("--belts", type=int, default=64)
    ap.add_argument("--image-res", type=int, default=256)
    ap.add_argument("--host-path-n", type=int, default=0,
                    help="rays of the host-path comparison (default: --n)")
    ap.add_argument("--chunk", type=int, default=DEFAULT_CHUNK,
                    help="rays a chunk of intersect_rays (0: one chunk)")
    records.add_output_args(ap)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = run(args.n, args.belts, args.image_res, args.host_path_n, args.chunk, args.device)
    records.emit(rec, args.out, args.label)
    # the two paths estimate the same irradiance integral
    if rec["flux_per_ray_agreement"] >= FLUX_BAR:
        raise SystemExit(f"flux per ray differs by {rec['flux_per_ray_agreement']} "
                         f"(bar {FLUX_BAR})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

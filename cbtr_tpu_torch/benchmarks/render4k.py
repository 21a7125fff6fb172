"""A 4K render: 4096 x 4096 collimated rays (16,777,216) through the robot lens.

Counterpart of benchmarks/render4k.py (BASELINE config 5's render, "4K
image, rays sharded").  Two halves:

* --gpu: the rays made on the device (`scene_ortho_grid`) through
  `parallel.multihost.render_multihost_ortho` on a group of one (no process
  group: the same code a many-card job runs), landing in a 1024^2 image.
  `intersect_rays` scans the rays in chunks of --chunk; the record gives
  the chunk beside the peak device memory, the wall time of the second
  call (the first builds and warms), rays/s, the image checksum, whether
  two calls gave the same image, the kernels' launches a render and the
  same grid in row-major order (`row_major`: the same ray multiset, another
  accumulation order);
* --procs N --res R: the same sharded render over N processes
  (`multiprocess_render`), asserting that every rank holds the same image.

Above 2 * 4 * rays * res bytes of splat weights (128^2 at 16.8M rays) the
splat adds into the pixels with the fixed-order segment sum
(`ops/cuda_segment.py`), so two calls give the same image bit for bit
(`deterministic`; `image_max_abs_diff_between_calls_rel` says by how much
they differ).  --deterministic runs the render under
`torch.use_deterministic_algorithms(True)` as a cross-check.

    python -m cbtr_tpu_torch.benchmarks.render4k --gpu [--res 4096]
        [--image-res 1024] [--chunk N] [--deterministic] [--out FILE]
        [--device cuda|cpu]
    python -m cbtr_tpu_torch.benchmarks.render4k --procs 2 --res 256
"""
from __future__ import annotations

import argparse
import json

import torch

from ..ops import cuda_lib
from . import records

# rays a chunk of intersect_rays at 4096^2: each chunk's kernel launch, its
# tables and its recompute (PERF.md, the 4K cells)
DEFAULT_CHUNK = 1 << 20


def _image_gap(a, b) -> dict:
    denom = max(float(a.abs().max()), 1e-30)
    return {"image_max_abs_diff_rel": float((b - a).abs().max()) / denom,
            "image_l2_diff_rel": float(torch.linalg.vector_norm(b - a))
            / max(float(torch.linalg.vector_norm(a)), 1e-30)}


def run_gpu(res: int = 4096, image_res: int = 1024, chunk: int = DEFAULT_CHUNK,
            device="cuda", scene=None, deterministic: bool = False) -> dict:
    """The --gpu half; returns its record.  scene: anything with the robot
    scene's `patches`, `refractive_index` and `screen_plane` (default
    `robot_lens_scene(res=1)` on the device: geometry only)."""
    from ..models import robot_lens_scene, scene_ortho_grid
    from ..parallel.multihost import multihost_mesh, render_multihost_ortho

    dev = records.resolve_device(device)
    scene = scene or robot_lens_scene(res=1, device=dev)
    grid = scene_ortho_grid(res)
    mesh = multihost_mesh()

    def render(g):
        with torch.no_grad():
            return render_multihost_ortho(mesh, scene.patches, scene.refractive_index, g,
                                          scene.screen_plane, resolution=image_res,
                                          chunk_size=chunk)

    with records.deterministic(deterministic):
        records.reset_peak(dev)
        img = render(grid)                                      # build + warm
        (img2, dt), launches = cuda_lib.counted(lambda: records.wall_s(lambda: render(grid),
                                                                      dev))
        peak = records.peak_gib(dev)
        # no warm-up of its own: nothing is compiled per layout
        img_rm, dt_rm = records.wall_s(lambda: render(grid._replace(tiled=False)), dev)
    assert bool(torch.isfinite(img).all()) and float(img.sum()) > 0, "empty or non-finite image"
    c1, c2 = records.checksum(img), records.checksum(img2)
    gap = _image_gap(img, img2)
    record = {
        "metric": f"sharded {res}x{res} robot render -> {image_res}^2 image",
        "rays": grid.n_rays,
        "wall_s": round(dt, 3),
        "rays_per_s": round(grid.n_rays / dt, 1),
        "image_checksum": c1,
        "deterministic": c1 == c2,
        "image_max_abs_diff_between_calls_rel": gap["image_max_abs_diff_rel"],
        "torch_deterministic_algorithms": deterministic,
        "image_sum": float(img.sum()),
        "live_ray_weight": float(img.sum()),
        "chunk": chunk,
        "peak_memory_gib": peak,
        "launches_per_render": launches,
        "row_major": {
            "wall_s": round(dt_rm, 3),
            "rays_per_s": round(grid.n_rays / dt_rm, 1),
            "image_checksum": records.checksum(img_rm),
            "live_ray_weight": float(img_rm.sum()),
            "live_ray_weight_delta": float(img_rm.sum() - img.sum()),
            **_image_gap(img, img_rm),
        },
        **records.card_fields(dev),
    }
    return record


def run_procs(nproc: int, res: int, device: str = "cuda") -> dict:
    """The sharded render over `nproc` processes (`multiprocess_render`),
    every rank's image the same."""
    from . import multiprocess_render

    runs = multiprocess_render.launch(nproc, res=res, mode="render", device=device)
    return {"metric": f"{nproc}-process {res}x{res} sharded render: replicated images "
                      "identical", "procs": nproc, "res": res, "ranks_equal": True,
            "image_checksum": records.checksum(torch.as_tensor(runs[0]["img"])),
            **records.card_fields(torch.device(device)), "n_devices": nproc}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gpu", action="store_true", help="the 4K render on one device")
    ap.add_argument("--procs", type=int, default=0, help="the sharded render over N processes")
    ap.add_argument("--res", type=int, default=4096)
    ap.add_argument("--image-res", type=int, default=1024)
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
        print(json.dumps(run_procs(args.procs, min(args.res, 256), args.device)), flush=True)
    if args.gpu:
        rec = run_gpu(args.res, args.image_res, args.chunk, args.device,
                      deterministic=args.deterministic)
        records.emit(rec, args.out, args.label)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Converged lens design: the reference's motivating car-lamp scenario
(reference/README.md:159-165, reference/hostUtil.cpp:9-29) run end to end,
a multi-hundred-step fit driving the screen pattern of a point source
toward a structured target.

Counterpart of benchmarks/design_lens.py.  The design variables are the
welded mesh vertices (`models/design.py`): every step rebuilds the patches
from them, so the derived tables stay exact at every iterate.  The emitter
rays are a deterministic low-discrepancy cone lattice (stratified cos x
golden-angle turn) aimed at the lens: the splat's Monte-Carlo noise sets
the reachable loss floor, and the lattice buys a far lower one than
independent samples at the same ray count.

    python -m cbtr_tpu_torch.benchmarks.design_lens [--smoke] [--steps N]
        [--rays N] [--res N] [--lr X] [--target flat|ring] [--cone-deg X]
        [--out FILE] [--device cuda|cpu]

prints the record (loss curve, wall time, rays/s, initial, best and final
losses and image checksums, the card) as its last line and asserts that the
pattern loss dropped at least 100x (10x with --smoke, the reduced run).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from . import records

# golden angle, radians
_GOLDEN_TURN = 2.399963229728653


def cone_lattice_rays(n: int, max_angle_deg: float, device="cuda"):
    """A point source at the origin, stratified cos (uniform over the
    spherical cap's area) x golden-angle turn over a cap of max_angle_deg
    around +x (the lens): (start, direction) [n, 3] f32 on `device`.  The
    cap models the solid angle a lamp reflector feeds the cover, and keeps
    every ray on the lens.  Built in NumPy, as the JAX package builds it, so
    the rays are the same bit for bit."""
    cos_min = float(np.cos(np.deg2rad(max_angle_deg)))
    i = np.arange(n)
    cosi = 1.0 - (i + 0.5) / n * (1.0 - cos_min)
    turn = (i * _GOLDEN_TURN) % (2.0 * np.pi)
    sini = np.sqrt(np.maximum(1.0 - cosi * cosi, 0.0))
    d = np.stack([cosi, sini * np.cos(turn), sini * np.sin(turn)], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return (torch.zeros((n, 3), dtype=torch.float32, device=device),
            torch.as_tensor(d, device=device))


def structured_target(kind: str, resolution: int, extent: float, radius: float,
                      sigma: float) -> np.ndarray:
    """[res, res] f32: "flat", a disk of the given radius with a sigmoid edge
    of width sigma (the car lamp's uniform pool of light); "ring", a
    Gaussian ring.  The flat top is the better-conditioned design."""
    c = (np.arange(resolution, dtype=np.float64) + 0.5) / resolution
    xy = (c - 0.5) * 2.0 * extent
    gx, gy = np.meshgrid(xy, xy, indexing="ij")
    r = np.sqrt(gx * gx + gy * gy)
    if kind == "flat":
        return (1.0 / (1.0 + np.exp((r - radius) / sigma))).astype(np.float32)
    return np.exp(-0.5 * ((r - radius) / sigma) ** 2).astype(np.float32)


def img_checksum(img) -> str:
    return records.checksum(torch.as_tensor(img, dtype=torch.float32))


def stages_for(smoke: bool, steps: int = 0, lr: float = 5e-4):
    """The staged Adam schedule: (peak lr, steps) a stage."""
    if steps:
        return [(lr, steps)]
    return [(2e-3, 100), (5e-4, 100)] if smoke else [(5e-4, 800), (1e-4, 800), (2e-5, 400)]


def run(smoke: bool = False, steps: int = 0, rays: int = 0, res: int = 0, lr: float = 5e-4,
        target: str = "flat", ring_r: float = 1.2, ring_sigma: float = 0.15,
        cone_deg: float = 13.0, device="cuda") -> dict:
    """The design run; returns its record (with the whole loss trajectory
    under "losses")."""
    from ..harness import preprocess
    from ..mesh.core import make_unit_sphere
    from ..models import design
    from ..models.scenes import LENS_CENTER

    dev = records.resolve_device(device)
    n_rays = rays or (4096 if smoke else 262144)
    res = res or (12 if smoke else 32)
    stages = stages_for(smoke, steps, lr)
    n_steps = sum(n for _, n in stages)
    extent = 4.0

    mesh = preprocess(make_unit_sphere(9, 5) if smoke else make_unit_sphere(15, 7))
    mesh.translate(LENS_CENTER)
    mesh = preprocess(mesh)
    screen = torch.tensor([1.0, 0.0, 0.0, 10.0], dtype=torch.float32, device=dev)
    s, d = cone_lattice_rays(n_rays, cone_deg, dev)

    topo, p0 = design.topology_from_mesh(mesh, device=dev)
    with torch.no_grad():
        # flux calibration: the target is scaled to the flux the initial
        # lens delivers (only img0's total is read)
        _, img0 = design.design_loss(p0, topo, s, d, screen,
                                     torch.ones((res, res), device=dev),
                                     resolution=res, extent=extent)
        shape = structured_target(target, res, extent, ring_r, ring_sigma)
        goal = torch.as_tensor(shape * (float(img0.sum()) / float(shape.sum())), device=dev)
        loss0, img0 = design.design_loss(p0, topo, s, d, screen, goal, resolution=res,
                                         extent=extent)
    loss0 = float(loss0)

    best = {"loss": float("inf"), "step": -1}

    def track(i, loss):
        if loss < best["loss"]:
            best.update(loss=loss, step=i)

    records.sync(dev)
    t0 = time.perf_counter()
    params, topo, losses = design.fit_design(mesh, goal, s, d, screen, stages=stages,
                                             resolution=res, extent=extent, on_step=track,
                                             device=dev)
    records.sync(dev)
    wall = time.perf_counter() - t0
    with torch.no_grad():
        _, img1 = design.design_loss(params, topo, s, d, screen, goal, resolution=res,
                                     extent=extent)
    drop = loss0 / max(best["loss"], 1e-30)
    return {
        "metric": "mesh-vertex lens design, point source -> ring (pattern+flux loss)",
        "steps": n_steps,
        "stages": [[lr_, n_] for lr_, n_ in stages],
        "rays": n_rays,
        "resolution": res,
        "lr": lr,
        "vertices": int(params.vertices.shape[0]),
        "patches": int(topo.face2vertex.shape[0]) * 3,
        "loss_initial": loss0,
        "loss_final": losses[-1],
        "loss_best": best["loss"],
        "loss_best_step": best["step"],
        "loss_drop_x": round(drop, 1),
        "wall_s": round(wall, 3),
        "rays_per_s_fwd_bwd": round(n_rays * n_steps / wall, 1),
        "image_checksum_initial": img_checksum(img0),
        "image_checksum_final": img_checksum(img1),
        "loss_curve": [round(x, 8) for x in losses[::max(1, len(losses) // 100)]],
        "losses": losses,
        "refractive_index_final": float(params.refractive_index),
        **records.card_fields(dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced-scale run (4096 rays, 12^2 image, 200 steps)")
    ap.add_argument("--steps", type=int, default=0, help="one stage of this many steps")
    ap.add_argument("--rays", type=int, default=0)
    ap.add_argument("--res", type=int, default=0, help="screen resolution")
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--target", choices=["flat", "ring"], default="flat")
    ap.add_argument("--ring-r", type=float, default=1.2)
    ap.add_argument("--ring-sigma", type=float, default=0.15)
    ap.add_argument("--cone-deg", type=float, default=13.0)
    records.add_output_args(ap)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = run(args.smoke, args.steps, args.rays, args.res, args.lr, args.target,
              args.ring_r, args.ring_sigma, args.cone_deg, args.device)
    rec.pop("losses")
    records.emit(rec, args.out, args.label)
    bar = 10.0 if args.smoke else 100.0
    if rec["loss_drop_x"] < bar:
        raise SystemExit(f"loss drop {rec['loss_drop_x']}x < {bar:g}x")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

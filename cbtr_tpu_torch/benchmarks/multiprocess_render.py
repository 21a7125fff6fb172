"""Multi-process ray-sharded render and train steps, and the check that every
rank holds the same replicated result.

Counterpart of benchmarks/multiprocess_render.py.  The launcher starts N
worker processes on this machine; each joins one torch.distributed group
through `parallel.multihost.init_distributed` (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE and RANK, which the launcher sets: gloo on the CPU, NCCL with
one card a rank), builds the same sphere lens, and traces its shard of the
rays through `parallel/multihost.py`:

* render (the default): `render_multihost`, a 32^2 image;
* --train: two `make_multihost_train_step` SGD steps, whose gradient sum
  crosses the process boundary;
* --train-ortho: two `make_multihost_train_step_ortho` steps, rays made on
  each rank from its slice of the grid (the 4K train step's path);
* --iters N (with --train): N more steps timed on rank 0's clock, for
  `scaling_bench`.

Every worker writes its image (or post-step parameters and losses) to
`<out>.proc<rank>.npz`; the launcher asserts that every rank's arrays are
equal and prints one JSON line, last.  The same code runs one process a
card on a machine with several cards.

    python -m cbtr_tpu_torch.benchmarks.multiprocess_render --procs 2
        [--res 16] [--train | --train-ortho] [--out PREFIX] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

MODES = ("render", "train", "train-ortho")
# seconds a launch waits for its workers before it kills them
TIMEOUT_S = 600


def worker(out: str, res: int, mode: str, device: str, iters: int = 0) -> None:
    """One rank (its place in the group from the environment)."""
    import torch
    import torch.distributed as dist

    from ..models import lens_model, sphere_lens_scene
    from ..models.scenes import SPHERE_BEAM_WIDTH, scene_ortho_grid
    from ..parallel import multihost as mh
    from . import records

    if not mh.init_distributed(backend="nccl" if device == "cuda" else "gloo"):
        raise RuntimeError("a worker needs MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK")
    rank, world = dist.get_rank(), dist.get_world_size()
    if device == "cuda":
        dev = records.resolve_device(f"cuda:{torch.cuda.current_device()}")
    else:
        torch.set_num_threads(1)         # one core a rank, as one card a rank
        dev = torch.device("cpu")
    try:
        # the same procedural scene on every rank (deterministic preprocessing)
        scene = sphere_lens_scene(res=res, sectors=9, belts=4, device=dev)
        mesh = mh.multihost_mesh()
        result = {"n_processes": world}
        if mode == "render":
            with torch.no_grad():
                img = mh.render_multihost(mesh, scene.patches, scene.refractive_index,
                                          scene.start, scene.direction, scene.screen_plane,
                                          resolution=32)
            assert torch.isfinite(img).all()
            result["img"] = img.cpu().numpy()
        else:
            params = lens_model.params_from_scene(scene)
            target = torch.zeros((32, 32), dtype=torch.float32, device=dev)
            if mode == "train":
                step = mh.make_multihost_train_step(mesh, scene.screen_plane, target,
                                                    resolution=32, learning_rate=1e-4)

                def run(p):
                    return step(p, scene.start, scene.direction)[:2]
            else:
                grid = scene_ortho_grid(res, beam_width=SPHERE_BEAM_WIDTH)
                step = mh.make_multihost_train_step_ortho(mesh, scene.screen_plane, target,
                                                          grid, resolution=32,
                                                          learning_rate=1e-4)

                def run(p):
                    return step(p)[:2]
            p1, loss1 = run(params)
            p2, loss2 = run(p1)
            result.update(cp=p2.control_points.detach().cpu().numpy(),
                          n_refr=p2.refractive_index.detach().cpu().numpy(),
                          loss1=float(loss1), loss2=float(loss2))
            if iters:
                records.sync(dev)
                t0 = time.perf_counter()
                for _ in range(iters):
                    p2, loss = run(p2)
                records.sync(dev)
                result.update(wall_s=time.perf_counter() - t0, iters=iters,
                              rays=int(scene.start.shape[0]))
        np.savez(f"{out}.proc{rank}", **result)
        print(f"rank {rank}/{world} {mode}: done", flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(nproc: int, out: str = "", res: int = 16, mode: str = "render",
           device: str = "cuda", iters: int = 0, timeout: float = TIMEOUT_S) -> list[dict]:
    """Run `nproc` workers and return each rank's arrays ({name: value}, in
    rank order) after asserting that every rank's are equal.  A worker that
    fails, or a launch that outlasts `timeout`, raises (and every worker
    still running is killed).  device "cuda" needs a card for each rank."""
    import torch

    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if device == "cuda":
        from . import records

        records.resolve_device(device)
        if nproc > torch.cuda.device_count():
            raise ValueError(f"{nproc} NCCL ranks need {nproc} cards; "
                             f"{torch.cuda.device_count()} here")
    if not out:
        out = os.path.join(tempfile.mkdtemp(prefix="cbtr_mp_"), "run")
    for r in range(nproc):
        if os.path.exists(f"{out}.proc{r}.npz"):
            os.remove(f"{out}.proc{r}.npz")
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs = []
    for rank in range(nproc):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(nproc), RANK=str(rank), OMP_NUM_THREADS="1")
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        env["PYTHONPATH"] = os.pathsep.join([root, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cbtr_tpu_torch.benchmarks.multiprocess_render",
             "--worker", "--out", out, "--res", str(res), "--mode", mode,
             "--device", device, "--iters", str(iters)],
            cwd=root, env=env))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"{nproc} workers still running after {timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"ranks {failed} failed: "
                           f"{[procs[r].returncode for r in failed]}")
    runs = []
    for r in range(nproc):
        with np.load(f"{out}.proc{r}.npz") as f:
            runs.append({k: f[k] for k in f.files})
    keys = ("img",) if mode == "render" else ("cp", "n_refr", "loss1", "loss2")
    for r in range(1, nproc):
        for k in keys:
            np.testing.assert_array_equal(runs[0][k], runs[r][k],
                                          err_msg=f"rank {r}'s {k} is not rank 0's")
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--out", default="", help="prefix of the ranks' .npz files "
                    "(default: a new temporary directory)")
    ap.add_argument("--res", type=int, default=16, help="ray grid resolution")
    ap.add_argument("--train", action="store_true",
                    help="two multihost SGD steps instead of a render")
    ap.add_argument("--train-ortho", action="store_true",
                    help="two SGD steps on rays made on each rank (the 4K step's path)")
    ap.add_argument("--iters", type=int, default=0, help="timed steps after --train's two")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--mode", default="render", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.out, args.res, args.mode, args.device, args.iters)
        return 0
    mode = "train" if args.train else ("train-ortho" if args.train_ortho else "render")
    runs = launch(args.procs, args.out, args.res, mode, args.device, args.iters)
    import torch

    from . import records

    head = runs[0]
    summary = {"mode": mode, "procs": args.procs, "res": args.res, "ranks_equal": True,
               **records.card_fields(torch.device(args.device)), "n_devices": args.procs}
    if mode == "render":
        summary["image_sum"] = float(head["img"].sum())
    else:
        summary.update(loss1=float(head["loss1"]), loss2=float(head["loss2"]))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

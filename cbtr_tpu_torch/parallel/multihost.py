"""Multi-process execution on torch.distributed.

Counterpart of cbtr_tpu/parallel/multihost.py.  One process drives one
device (one rank a card under NCCL, or a CPU process under gloo), and the
ranks form a 1-D mesh over which the rays are split:

* every rank traces only its own slice of the rays: uploaded from the
  global host arrays (`process_ray_shard`), or synthesized on the device
  from its slice of the global ray indices (`OrthoGrid.rays_at`,
  `emitters.synthesize`), so no rank holds the whole ray set;
* the lens (a few hundred KB of tables) is replicated;
* the partial images are summed over the mesh, and the loss is taken on the
  full image on every rank; the control-point and refractive-index
  gradients are summed over the mesh before the SGD update, so every rank
  applies the same step (`sharding.sgd_step`, which says why the image sum
  has the identity as its backward).

The JAX package's XLA partitioner inserted the gradient all-reduce itself;
here it is the one explicit `all_reduce` of `sgd_step`.  With no process
group (mesh=None) every function is the single-process computation.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..render import emitters
from ..render.render import render_lens_image
from .sharding import axis_group, ray_device_mesh, sgd_step, sum_over


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> bool:
    """Join (or skip) the torch.distributed process group.

    Explicit arguments, or torch's environment variables: MASTER_ADDR and
    MASTER_PORT (the coordinator, "host:port"), WORLD_SIZE, RANK.  The
    coordinator may also be a full init method ("tcp://...", "file://...").
    backend: "nccl" where CUDA is available, else "gloo"; under NCCL a rank
    takes card rank % device_count.  Returns True once the group runs, and
    False when nothing is configured: a single process, for which every
    function of this package computes as a world of one."""
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs the coordinator, the number of "
                         f"processes and this process's id; got {coordinator_address!r}, "
                         f"{num_processes!r}, {process_id!r}")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return True


def multihost_mesh(axis: str = "rays", num_devices: Optional[int] = None):
    """1-D mesh over every rank (the ray axis), None without a process
    group.  One flat axis is the right shape: rays need no communication,
    so the only collectives are the image sum and the gradient sum."""
    return ray_device_mesh(num_devices, axis)


def process_ray_shard(start, direction, mesh, axis: str = "rays", device="cuda"):
    """This rank's slice of the global rays, padded to a multiple of the
    ranks along `axis`: (start, direction, weight), each [R_pad / n, ...] f32
    on `device`.

    start/direction are the global [R,3] rays (NumPy arrays or tensors, the
    same on every rank); only this rank's slice goes to the device.  weight
    is 1 for a real ray and 0 for a padding ray.  Callers must pass it to
    the splat (`render_lens_image(weights=)`): the padding rays start at the
    origin heading -x, away from every scene, but that is only a second
    line of defence."""
    _, n, i = axis_group(mesh, axis)
    start = torch.as_tensor(start, dtype=torch.float32)
    direction = torch.as_tensor(direction, dtype=torch.float32)
    R = start.shape[0]
    pad = (-R) % n
    weight = torch.ones(R + pad, dtype=torch.float32, device=start.device)
    if pad:
        weight[R:] = 0.0
        start = torch.cat([start, start.new_zeros(pad, 3)])
        d_pad = direction.new_zeros(pad, 3)
        d_pad[:, 0] = -1.0
        direction = torch.cat([direction, d_pad])
    per = (R + pad) // n
    rows = slice(i * per, (i + 1) * per)
    return start[rows].to(device), direction[rows].to(device), weight[rows].to(device)


def _local_indices(mesh, axis: str, n_rays: int, device):
    """This rank's contiguous slice of the global ray indices [0, n_rays)."""
    _, n, i = axis_group(mesh, axis)
    if n_rays % n:
        raise ValueError(f"{n_rays} rays do not split over {n} ranks")
    per = n_rays // n
    return torch.arange(i * per, (i + 1) * per, dtype=torch.int64, device=device)


def render_multihost(mesh, patches, refractive_index, start, direction,
                     screen_plane, resolution: int = 128, extent: float = 4.0,
                     chunk_size: int = 0, axis: str = "rays"):
    """Sharded forward render of the global rays start/direction (see
    `process_ray_shard`): the [res, res] image, the same on every rank."""
    group, _, _ = axis_group(mesh, axis)
    s, d, w = process_ray_shard(start, direction, mesh, axis, patches.device)
    img = render_lens_image(patches, refractive_index, s, d, screen_plane, extent=extent,
                            resolution=resolution, chunk_size=chunk_size, weights=w)
    return sum_over(img, group)


def render_multihost_ortho(mesh, patches, refractive_index, grid, screen_plane,
                           resolution: int = 128, extent: float = 4.0,
                           chunk_size: int = 0, axis: str = "rays"):
    """Sharded render with each rank's rays synthesized on the device from
    an OrthoGrid (`rays_at` on its slice of the grid's indices): no host
    grid, no upload (403 MB at 4096^2).  grid.n_rays must split evenly."""
    group, _, _ = axis_group(mesh, axis)
    s, d = grid.rays_at(_local_indices(mesh, axis, grid.n_rays, patches.device))
    img = render_lens_image(patches, refractive_index, s, d, screen_plane, extent=extent,
                            resolution=resolution, chunk_size=chunk_size)
    return sum_over(img, group)


def render_multihost_emitter(mesh, patches, refractive_index, emitter, screen_plane,
                             resolution: int = 128, extent: float = 4.0,
                             chunk_size: int = 0, axis: str = "rays"):
    """Sharded point-source render with each rank's rays synthesized on the
    device by a DeviceEmitter.  Its index space is bin-ordered, so a rank's
    contiguous slice is a contiguous run of hemisphere bins, and a ray is a
    function of (seed, global index) alone: any rank count traces the same
    rays.  emitter.n_rays must split evenly."""
    group, _, _ = axis_group(mesh, axis)
    s, d, w = emitters.synthesize(emitter, _local_indices(mesh, axis, emitter.n_rays,
                                                          patches.device))
    img = render_lens_image(patches, refractive_index, s, d, screen_plane, extent=extent,
                            resolution=resolution, chunk_size=chunk_size, weights=w)
    return sum_over(img, group)


def make_multihost_train_step(mesh, screen_plane, target, resolution: int = 128,
                              extent: float = 4.0, learning_rate: float = 1e-3,
                              chunk_size: int = 0, axis: str = "rays"):
    """SGD step over the mesh: run(params, start, direction) -> (params,
    loss), start/direction the global rays (sliced and padded per rank by
    `process_ray_shard`, padding weighted 0).  params is a LensParams, the
    same on every rank (`sharding.replicate`), updated in place."""
    group, _, _ = axis_group(mesh, axis)

    def run(params, start, direction):
        s, d, w = process_ray_shard(start, direction, mesh, axis,
                                    params.control_points.device)
        loss, _ = sgd_step(params, lambda p: p(s, d, screen_plane, resolution=resolution,
                                               extent=extent, chunk_size=chunk_size,
                                               ray_weights=w),
                           target, learning_rate, group)
        return params, loss

    return run


def make_multihost_train_step_ortho(mesh, screen_plane, target, grid,
                                    resolution: int = 128, extent: float = 4.0,
                                    learning_rate: float = 1e-3, chunk_size: int = 0,
                                    axis: str = "rays"):
    """SGD step with each rank's rays synthesized on the device from an
    OrthoGrid: run(params) -> (params, loss, (grad cp, grad n)); the
    gradients are the mesh's sums."""
    group, _, _ = axis_group(mesh, axis)

    def run(params):
        s, d = grid.rays_at(_local_indices(mesh, axis, grid.n_rays,
                                           params.control_points.device))
        loss, grads = sgd_step(params, lambda p: p(s, d, screen_plane, resolution=resolution,
                                                   extent=extent, chunk_size=chunk_size),
                               target, learning_rate, group)
        return params, loss, grads

    return run


def make_multihost_train_step_emitter(mesh, screen_plane, target, emitter,
                                      resolution: int = 128, extent: float = 4.0,
                                      learning_rate: float = 1e-3, chunk_size: int = 0,
                                      axis: str = "rays"):
    """SGD step on point-source rays synthesized per rank by a DeviceEmitter
    (the car-lamp scenario, reference/README.md:159-165): run(params) ->
    (params, loss, (grad cp, grad n))."""
    group, _, _ = axis_group(mesh, axis)

    def run(params):
        s, d, w = emitters.synthesize(emitter, _local_indices(
            mesh, axis, emitter.n_rays, params.control_points.device))
        loss, grads = sgd_step(params, lambda p: p(s, d, screen_plane, resolution=resolution,
                                                   extent=extent, chunk_size=chunk_size,
                                                   ray_weights=w),
                               target, learning_rate, group)
        return params, loss, grads

    return run

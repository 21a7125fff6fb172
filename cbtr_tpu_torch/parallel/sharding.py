"""Ray sharding over a device mesh on torch.distributed.

Counterpart of cbtr_tpu/parallel/sharding.py.  The scaling axis of the
workload is the ray count: every rank traces its own shard of the rays
against the whole (replicated) lens, and the one collective of a forward is
the sum of the partial images.  A JAX `Mesh` becomes a
`torch.distributed.device_mesh.DeviceMesh` with named dimensions; the JAX
package's SPMD partitioner inserted the gradient all-reduce itself, here
`sgd_step` does it by hand.

The loss is an MSE of the SUMMED image, which is not linear in it, so the
per-rank losses cannot simply be averaged (as DDP does).  Instead:

* the partial images are all-reduced (sum) over the ray dimension by
  `sum_over`, whose backward is the identity: every rank then holds the
  full image and computes the same loss, and the image gradient each rank
  back-propagates is already the full one, for its own rays;
* the parameter gradients are all-reduced (sum) over the ray dimension
  only.  Ranks that differ only in another dimension (the patch dimension
  of `patch_parallel`) hold the same rays and compute the same gradient,
  so a sum over them would count it that many times.

(`torch.distributed.nn.functional.all_reduce` is not used: its backward
all-reduces the incoming gradient again, which with the loss on every rank
makes the image gradient world-size times too large.)

Every function takes `mesh=None` for a world of one: no process group, no
collective, the single-process result.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..models.lens_model import LensParams
from ..render.render import render_lens_image
from ..utils.profiling import span


def mesh_device_type() -> str:
    """"cuda" for an NCCL process group, "cpu" otherwise (gloo)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def ray_device_mesh(num_devices: Optional[int] = None, axis: str = "rays"):
    """1-D DeviceMesh over every rank of the running process group, or None
    (a world of one) without one.  num_devices, if given, must be the
    world size: a mesh spans the whole group (one rank a device)."""
    if not dist.is_initialized():
        if num_devices not in (None, 1):
            raise ValueError(f"no process group: a mesh of {num_devices} ranks cannot exist")
        return None
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if num_devices not in (None, n):
        raise ValueError(f"the process group has {n} ranks, not {num_devices}")
    return init_device_mesh(mesh_device_type(), (n,), mesh_dim_names=(axis,))


def axis_group(mesh, axis: str):
    """(process group, size, this rank's index) along mesh dimension `axis`;
    (None, 1, 0) for mesh=None."""
    if mesh is None:
        return None, 1, 0
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), mesh.get_local_rank(axis)


def shard_rays(mesh, array, axis: str = "rays"):
    """This rank's slice of the leading (ray) axis along mesh dimension
    `axis`; the ray count must divide evenly (padding is the caller's job,
    e.g. multihost.process_ray_shard)."""
    _, n, i = axis_group(mesh, axis)
    if array.shape[0] % n:
        raise ValueError(f"{array.shape[0]} rays do not split over {n} ranks")
    per = array.shape[0] // n
    return array[i * per:(i + 1) * per]


def replicate(mesh, obj):
    """Make `obj` (a tensor, BezierPatches or nn.Module) hold the first
    rank's values on every rank: a broadcast over the process group (in
    place for a module's parameters and buffers).  Identity for mesh=None."""
    if mesh is None:
        return obj
    src = int(mesh.mesh.reshape(-1)[0])
    if isinstance(obj, torch.nn.Module):
        with torch.no_grad():
            for t in [*obj.parameters(), *obj.buffers()]:
                dist.broadcast(t.data, src)
        return obj
    if isinstance(obj, torch.Tensor):
        out = obj.clone()
        dist.broadcast(out, src)
        return out
    return obj.map(lambda t: replicate(mesh, t))


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) in the forward, the identity in the backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over(x, group):
    """Sum of every rank's `x` over `group` (None: x itself), with the
    identity as its backward (see the module docstring)."""
    return x if group is None else _SumOver.apply(x, group)


@span("cbtr.step")
def sgd_step(params: LensParams, partial_image, target, learning_rate: float,
             group):
    """One SGD step on a ray-sharded image: partial_image(params) -> this
    rank's [res, res] image; the images are summed over `group`, the loss
    `mean((img - target)^2)` is taken on the full image on every rank, and
    the gradients are summed over `group` before the update
    (p <- p - lr * grad, in place).  Returns (loss, (grad cp, grad n)); the
    gradients stay in `.grad` as well.  The step is the span `cbtr.step`,
    its image and loss `cbtr.step.forward`, then `.backward`, the gradients'
    sum `.allreduce` (only where there is a group) and `.update`, the names
    of `models/lens_model.py`'s steps (`utils.profiling`)."""
    params.zero_grad(set_to_none=True)
    with span("cbtr.step.forward"):
        img = sum_over(partial_image(params), group)
        loss = torch.mean((img - target) ** 2)
    with span("cbtr.step.backward"):
        loss.backward()
    grads = (params.control_points.grad, params.refractive_index.grad)
    if group is not None:
        with span("cbtr.step.allreduce"):
            for g in grads:
                dist.all_reduce(g, group=group)
    with span("cbtr.step.update"), torch.no_grad():
        for p, g in zip((params.control_points, params.refractive_index), grads):
            p -= learning_rate * g
    return loss.detach(), grads


def render_sharded(mesh, patches, refractive_index, start, direction,
                   screen_plane, resolution: int = 128, extent: float = 4.0,
                   axis: str = "rays"):
    """Forward render with the rays sharded over mesh dimension `axis`:
    start/direction are the global rays (same on every rank), each rank
    traces its shard, and the partial images are summed over `axis`.  Every
    rank returns the full image."""
    group, _, _ = axis_group(mesh, axis)
    img = render_lens_image(
        patches, refractive_index, shard_rays(mesh, start, axis),
        shard_rays(mesh, direction, axis), screen_plane, extent=extent,
        resolution=resolution,
    )
    return sum_over(img, group)


def make_sharded_train_step(mesh, screen_plane, target, resolution: int = 128,
                            extent: float = 4.0, learning_rate: float = 1e-3,
                            axis: str = "rays", patch_axis: Optional[str] = None):
    """SGD train step over the mesh: run(params, start, direction) ->
    (params, loss), with the global rays sharded over `axis` and the
    gradient summed over it (`sgd_step`); the parameters (a LensParams,
    which holds its tables: no `patches` argument) move in place and must
    start equal on every rank (`replicate`).

    patch_axis: a second mesh dimension to split the intersection's patch
    sweep over (`patch_parallel.intersect_rays_patch_sharded` through
    `refract_rays(intersect_fn=)`), for a 2-D ('rays', 'patches') mesh."""
    group, _, _ = axis_group(mesh, axis)
    intersect_fn = None
    if patch_axis is not None:
        from .patch_parallel import intersect_rays_patch_sharded

        def intersect_fn(patches, s, d):
            return intersect_rays_patch_sharded(patches, s, d, mesh, patch_axis)

    def run(params: LensParams, start, direction):
        s, d = shard_rays(mesh, start, axis), shard_rays(mesh, direction, axis)

        def partial_image(p):
            return render_lens_image(p.patches(), p.refractive_index, s, d, screen_plane,
                                     extent=extent, resolution=resolution,
                                     intersect_fn=intersect_fn)

        loss, _ = sgd_step(params, partial_image, target, learning_rate, group)
        return params, loss

    return run

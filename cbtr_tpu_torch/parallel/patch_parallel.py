"""Patch-sharded intersection: the tensor-parallel axis of the raytracer.

Counterpart of cbtr_tpu/parallel/patch_parallel.py.  The sweep is
O(rays x patches), so the patch axis is split over a mesh dimension: every
rank sweeps its rays against its own patch shard (K3, csrc/sweep_codes.cu,
on CUDA tensors; its plain twin on CPU tensors), the per-pair codes and
distances (8 bytes a pair) are all-gathered along the patch dimension so
that every rank runs the integer select over the whole table, follow-side
retries across shard boundaries included (reference/bezierMesh.cpp:213-217),
and each rank re-evaluates its rays' winning patches from the replicated
patch table.  Gradients flow through that O(R) recompute alone, so the
backward has no collective of its own.

Composes with ray sharding into a 2-D ('rays', 'patches') mesh
(`sharding.make_sharded_train_step(patch_axis=)`): ranks that differ only
along the patch dimension hold the same rays.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..bezier.patches import BezierPatches
from ..ops import cuda_codes
from ..ops.intersect import BACKENDS, RayHit, recompute_winner, select_candidates
from .sharding import axis_group, shard_rays


def pad_patches(patches: BezierPatches, multiple: int) -> BezierPatches:
    """Pad the patch axis to a multiple of `multiple` with zero rows: a zero
    underlying plane has a zero normal, so |cos| < epsilon and no ray gets a
    candidate from them (their neighbours, 0, are never voted for)."""
    pad = (-patches.num_patches) % multiple
    if pad == 0:
        return patches
    return patches.map(lambda x: torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]))


def _gather_rows(x, group, n: int):
    """Concatenation over `group` of every rank's `x` along dim 0 (rank
    order); x itself for a group of one."""
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def intersect_rays_patch_sharded(patches: BezierPatches, start, direction, mesh,
                                 patch_axis: str = "patches",
                                 ray_axis: Optional[str] = None,
                                 backend: str = "auto") -> RayHit:
    """Intersection with the patches split over mesh dimension `patch_axis`.

    start/direction [R,3]: the rays of this rank, the same on every rank of
    its patch group; with `ray_axis`, the global rays, of which this rank
    takes its shard along that dimension (`sharding.shard_rays`) and returns
    the RayHit of those rows only, as the JAX function's sharded output
    holds one shard per device.  mesh=None is a world of one.
    backend: "auto" (K3 on CUDA tensors, its plain twin on CPU tensors) or
    "plain" (the twin on any device).  The sweep and the select run without
    gradients on detached inputs; `recompute_winner` on the full patches is
    the only differentiable stage.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if ray_axis is not None:
        start, direction = shard_rays(mesh, start, ray_axis), shard_rays(mesh, direction, ray_axis)
    s, d = start.reshape(-1, 3).to(torch.float32), direction.reshape(-1, 3).to(torch.float32)
    group, n, i = axis_group(mesh, patch_axis)
    P = patches.num_patches
    padded = pad_patches(patches.detach(), n)
    per = padded.num_patches // n
    local = padded.map(lambda x: x[i * per:(i + 1) * per])
    sweep = (cuda_codes.sweep_codes_reference if backend == "plain"
             else cuda_codes.sweep_codes_cuda)
    with torch.no_grad():
        code, dist_ = sweep(local, s.detach(), d.detach())           # [R, per]
        # patch-major rows, gathered in rank order, padding rows dropped
        code = _gather_rows(code.T, group, n)[:P].T                  # [R, P]
        dist_ = _gather_rows(dist_.T, group, n)[:P].T
        any_hit, win, _ = select_candidates(code, dist_, patches.neighbours)
    hit = recompute_winner(patches, s, d, any_hit, win)
    batch = start.shape[:-1]
    return RayHit(*(x.reshape(batch + x.shape[1:]) for x in hit))

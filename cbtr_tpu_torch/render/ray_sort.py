"""Ray-coherence sorting (the reference's warp-coherence emitter binning,
reference/README.md:169-192, hostUtil.cpp:9-28, re-purposed).

Counterpart of cbtr_tpu/render/ray_sort.py.  The sweep kernels cull per
(128-ray tile x patch block): a block is skipped for a tile only when all
128 rays miss it, so spatially coherent tiles skip far more work.  This
module manufactures that coherence for arbitrarily ordered rays (emitter
bundles, shuffled batches):

* `coherence_keys` -- per-ray sort key: the direction octant above a
  coarse Morton code of the origin within the batch's bounding box (integer
  keys, equal to the JAX package's);
* `sort_rays` -- torch's stable argsort by key and its inverse, so
  `intersect_rays_sorted` returns results in the caller's ray order.

Ortho camera grids are already tile-coherent; the win case is hemisphere
emitters and shuffled ray batches.
"""
from __future__ import annotations

import torch

from ..ops.intersect import RayHit, intersect_rays


def _morton3(q, bits: int = 5):
    """Interleave `bits` bits of 3 quantized coordinates, [N,3] i32 -> [N] i32."""
    out = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    for b in range(bits):
        for axis in range(3):
            out = out | (((q[:, axis] >> b) & 1) << (3 * b + axis))
    return out


def coherence_keys(start, direction, origin_bits: int = 5):
    """Per-ray spatial-coherence sort key [N] i32: (direction octant <<
    3*bits) | morton(origin within the batch's bounding box)."""
    start = torch.as_tensor(start, dtype=torch.float32)
    direction = torch.as_tensor(direction, dtype=torch.float32)
    octant = (
        (direction[:, 0] > 0).to(torch.int32)
        | ((direction[:, 1] > 0).to(torch.int32) << 1)
        | ((direction[:, 2] > 0).to(torch.int32) << 2)
    )
    lo = start.amin(dim=0)
    span = (start.amax(dim=0) - lo).clamp_min(1e-6)
    scale = (1 << origin_bits) - 1
    q = ((start - lo) / span * scale).to(torch.int32).clamp(0, scale)
    return (octant << (3 * origin_bits)) | _morton3(q, origin_bits)


def sort_rays(start, direction, keys=None):
    """-> (start_sorted, direction_sorted, inverse permutation).

    keys: optional precomputed [N] keys (e.g. the emitter's bin from
    UniformHemisphere.sample, the reference's own binning)."""
    if keys is None:
        keys = coherence_keys(start, direction)
    perm = torch.argsort(torch.as_tensor(keys, device=start.device), stable=True)
    inv = torch.argsort(perm, stable=True)
    return start[perm], direction[perm], inv


def intersect_rays_sorted(patches, start, direction, keys=None,
                          chunk_size: int = 0, backend: str = "auto") -> RayHit:
    """`intersect_rays` with the coherence sort and unsort around it: the
    same results, in the caller's ray order."""
    s, d, inv = sort_rays(start, direction, keys)
    hit = intersect_rays(patches, s, d, chunk_size=chunk_size, backend=backend)
    return RayHit(*(leaf[inv] for leaf in hit))

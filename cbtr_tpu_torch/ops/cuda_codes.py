"""Per-pair sweep codes on the GPU: the CUDA kernel K3, its wrapper and its
plain PyTorch twin.

Counterpart of the staged sweep of cbtr_tpu/ops/pallas_sweep.py
(`_sweep_kernel_resident`, `_sweep_call`, `sweep_codes_pallas`): for every
(ray, patch) pair the gate-OFF candidate code ``what | (in_domain << 3)``
and the along-ray distance, as (code [R, P] i32, dist [R, P] f32).  The
staged pipeline feeds them to `intersect.select_candidates`; the bench
times it as its sweep stage and checks the recompute against it.

The candidate set is the JAX kernel's, at its block size of 32 patches
(`pallas_sweep.BLOCK_P`; K1 and K2 use 16):

* a block is listed for a 128-ray tile when some ray of the tile hits its
  merged sphere AND its union AABB (`cuda_sweep.block_bounds` at block 32):
  the kernel culls for its own tile (csrc/block_walk.cuh, as K1 and K2 do),
  the plain twin reads the same test from
  `cuda_sweep.tile_block_lists(block_p=32)`;
* a listed block is evaluated for all 128 rays when any (patch, ray) pair
  of block x tile passes the per-patch sphere test;
* every other pair keeps code WHAT_NONE and dist 0.0, the values the TPU
  kernel writes before its block loop (`pallas_sweep.py:148-149`).

The TPU entry point chunks patches at `_RESIDENT_MAX_P` = 8192 rows (VMEM)
and rays at `_SMEM_LIST_BUDGET` (SMEM for the prefetched lists).  Both are
memory workarounds that change no output; K3 takes the whole table in one
launch and builds no lists.  Its patch table is padded to 128 rows (K1's), not to
32; the extra rows are all-padding blocks that are never listed.

`sweep_codes_cuda` launches csrc/sweep_codes.cu for CUDA tensors and calls
`sweep_codes_reference` for CPU tensors; it never falls back from one to
the other.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..bezier.patches import BezierPatches
from ..config import DEFAULT as CFG
from . import cuda_lib
from . import cuda_sweep as cs
from . import cuda_tables
from . import intersect as ix

# patches per candidate block: the JAX kernel's BLOCK_P
BLOCK_P = 32

# (ray, patch) pairs per chunk of the plain twin (K2's twin's bound)
_REFERENCE_CHUNK_PAIRS = cs._REFERENCE_CHUNK_R * 512

# cbtr_sweep_codes' parameters: 8 pointers, T, P, P_pad, block_p, use_aabb,
# iterations, 4 tolerances, clamp_secant, the mode, the stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float] * 4 \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def sweep_codes_reference(patches: BezierPatches, start, direction,
                          use_aabb: bool = True):
    """Plain PyTorch version of K3: (code [R, P] i32, dist [R, P] f32).

    Dense `intersect.sweep_codes` in the mode config asks for
    (`intersect.sweep_mode()`), then (WHAT_NONE, 0.0) on every pair
    outside `cuda_sweep.gated_pairs(..., block_p=32)`.  Rays go in
    chunks of whole tiles, about _REFERENCE_CHUNK_PAIRS pairs each."""
    R = start.shape[0]
    P = patches.num_patches
    rays_t = cs.pad_rays(start.to(torch.float32), direction.to(torch.float32))
    patch_t = cs.pack_patch_table(patches)
    listed = cs.listed_blocks(
        *cs.tile_block_lists(patches, rays_t, BLOCK_P, use_aabb),
        patch_t.shape[0], BLOCK_P)

    mode = ix.sweep_mode()
    tiles_per_chunk = max(1, _REFERENCE_CHUNK_PAIRS // (cs.TILE_R * P))
    codes, dists = [], []
    for t0 in range(0, listed.shape[0], tiles_per_chunk):
        rt = rays_t[:, t0 * cs.TILE_R:(t0 + tiles_per_chunk) * cs.TILE_R]
        keep = cs.gated_pairs(listed[t0:t0 + tiles_per_chunk],
                              cs.sphere_hit_pairs(patch_t, rt), BLOCK_P)[:, :P]
        code, dist = ix.sweep_codes(patches, rt[0:3].T, rt[3:6].T, mode)
        codes.append(torch.where(keep, code, ix.WHAT_NONE))
        dists.append(torch.where(keep, dist, 0.0))
    return torch.cat(codes)[:R], torch.cat(dists)[:R]


# ---------------------------------------------------------------------------
# the kernel: tables, load, launch
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CodesInputs:
    """Everything one launch of K3 reads, built by `prepare_inputs`."""

    rays_t: torch.Tensor    # [8, R_pad] f32
    patch_t: torch.Tensor   # [P_pad, 64] f32
    bounds: torch.Tensor    # [P_pad / 32, 12] f32 (`cuda_sweep.block_bounds`)
    num_patches: int
    use_aabb: bool = True   # the cull's AABB leg (`cuda_sweep.tile_block_lists`)


@dataclasses.dataclass(frozen=True)
class CodesOutputs:
    """What one launch of K3 writes (`launch`)."""

    code: torch.Tensor      # [P_pad, R_pad] i32, WHAT_NONE where not evaluated
    dist: torch.Tensor      # [P_pad, R_pad] f32, 0.0 where not evaluated
    counts: torch.Tensor    # [T] i32 blocks the tile's cull listed
    lists: torch.Tensor | None = None   # [B, T] i32: lists[:counts[t], t] ascending
    pairs: torch.Tensor | None = None   # [T] i32: (ray, patch) pairs evaluated


def prepare_inputs(patches: BezierPatches, start, direction,
                   use_aabb: bool = True) -> CodesInputs:
    """K3's tables on the rays' device: K1's rays (`cuda_tables.pack_rays`);
    the patch table and the block bounds at block 32 from
    `cuda_tables.build_tables`; use_aabb as in `cuda_sweep.tile_block_lists`.
    No lists: the kernel culls for itself."""
    device = start.device
    if patches.device != device or direction.device != device:
        raise ValueError("patches, start and direction must share one device")
    rays_t = cuda_tables.pack_rays(start.to(torch.float32).contiguous(),
                                   direction.to(torch.float32).contiguous())
    patch_t, bounds, _ = cuda_tables.build_tables(patches, BLOCK_P)
    return CodesInputs(rays_t, patch_t, bounds, patches.num_patches, use_aabb)


def filled_outputs(inputs: CodesInputs):
    """K3's outputs before a launch: (code [P_pad, R_pad] i32 all WHAT_NONE,
    dist [P_pad, R_pad] f32 all 0.0), on the tables' device."""
    shape, device = (inputs.patch_t.shape[0], inputs.rays_t.shape[1]), inputs.rays_t.device
    return (torch.full(shape, ix.WHAT_NONE, dtype=torch.int32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device))


def check_inputs(inputs: CodesInputs):
    """Raise unless `inputs` are tables K3 takes: CUDA tensors of the shapes,
    types and layout `prepare_inputs` gives.  Returns (T, P_pad)."""
    device = inputs.rays_t.device
    R_pad, P_pad = inputs.rays_t.shape[-1], inputs.patch_t.shape[0]
    if R_pad % cs.TILE_R or P_pad % cs._PATCH_PAD or not 0 < inputs.num_patches <= P_pad:
        raise ValueError(f"unsupported shape: P = {inputs.num_patches}, "
                         f"R_pad = {R_pad}, P_pad = {P_pad}")
    for t, name, dtype, shape in (
        (inputs.rays_t, "rays_t", torch.float32, (8, R_pad)),
        (inputs.patch_t, "patch_t", torch.float32, (P_pad, cs._N_ROWS)),
        (inputs.bounds, "bounds", torch.float32, (P_pad // BLOCK_P, cs._N_BOUNDS)),
    ):
        cuda_lib.check_tensor(t, name, dtype, shape, device)
    if device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA tensors, got {device}; on the CPU "
                         "its plain twin computes the same function")
    return R_pad // cs.TILE_R, P_pad


def launch(inputs: CodesInputs, out=None, lists: bool = False,
           pairs: bool = False) -> CodesOutputs:
    """One launch of K3 on the current stream over tables from
    `prepare_inputs`, in the mode config asks for (`intersect.sweep_mode()`):
    code [P_pad, R_pad] i32 and dist [P_pad, R_pad] f32,
    patch-major as the TPU kernel writes them, (WHAT_NONE, 0.0) on every
    pair it does not evaluate, and the per-tile counts of its cull.  lists /
    pairs also fill the per-tile lists and evaluated pairs (for checks; the
    wrapper asks for neither).

    The kernel writes only the pairs it evaluates, into `out`: by default
    fresh `filled_outputs`; outputs of an earlier launch on the same inputs
    come back unchanged (how the kernel is timed without the fill)."""
    T, P_pad = check_inputs(inputs)
    device, R_pad, B = inputs.rays_t.device, T * cs.TILE_R, P_pad // BLOCK_P
    code, dist = filled_outputs(inputs) if out is None else out
    cuda_lib.check_tensor(code, "code", torch.int32, (P_pad, R_pad), device)
    cuda_lib.check_tensor(dist, "dist", torch.float32, (P_pad, R_pad), device)
    result = CodesOutputs(
        code, dist, counts=torch.empty(T, dtype=torch.int32, device=device),
        lists=torch.full((B, T), -1, dtype=torch.int32, device=device) if lists else None,
        pairs=torch.zeros(T, dtype=torch.int32, device=device) if pairs else None)

    cuda_lib.call(
        "sweep_codes", _ARGTYPES, device,
        inputs.rays_t.data_ptr(), inputs.patch_t.data_ptr(),
        inputs.bounds.data_ptr(), code.data_ptr(), dist.data_ptr(),
        result.counts.data_ptr(),
        result.lists.data_ptr() if lists else None,
        result.pairs.data_ptr() if pairs else None,
        T, inputs.num_patches, P_pad, BLOCK_P, int(inputs.use_aabb),
        int(CFG.root_search_iterations),
        CFG.ray_plane_intersection_epsilon,
        CFG.intersection_estimation_epsilon,
        CFG.max_intersection_distance_from_ray,
        CFG.minimal_ray_distance,
        int(CFG.clamp_secant_estimate),
        ix.sweep_mode().code,
    )
    return result


def sweep_codes_cuda(patches: BezierPatches, start, direction,
                     use_aabb: bool = True):
    """K3 wrapper: (code [R, P] i32, dist [R, P] f32), the counterpart of
    `sweep_codes_pallas`.

    CPU tensors go to `sweep_codes_reference`; CUDA tensors launch
    csrc/sweep_codes.cu (both in the mode config asks for) and get the
    [R, P] (transposed, not contiguous) view of its patch-major output.
    There is no fallback between the two: a build or launch failure raises."""
    if not start.is_cuda:
        return sweep_codes_reference(patches, start, direction, use_aabb)
    out = launch(prepare_inputs(patches, start, direction, use_aabb))
    R, P = start.shape[0], patches.num_patches
    return out.code.T[:R, :P], out.dist.T[:R, :P]

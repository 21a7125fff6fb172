"""Per-ray winner for any patch count on the GPU: the CUDA kernel K2, its
wrapper and its plain PyTorch twin.

Counterpart of the winner path of cbtr_tpu/ops/pallas_sweep.py
(`pack_winner_tables`, `_winner_kernel`, `_winner_call`,
`sweep_winner_pallas`), which the JAX package's `intersect_rays` runs for
every lens above _FUSED_MAX_P = 1024 patches.  Returns, like K1, the winner
of reference/bezierMesh.cpp:206-227's scan with one forward retry:
(any_hit [R] bool, win [R] i32, win_dist [R] f32), min distance, lowest
patch id on ties.

Blocks, cull and gate are K1's (cuda_sweep.py).  The retry rule is the
TPU winner kernel's, not K1's: a voter p of an evaluated block whose gate-ON
result is cFollowSide_s contributes q = neighbours[p, s] (clipped to
[0, P), as `pack_winner_tables` clips) when q's gate-OFF result is
cIntersect and the ray hits q's own inflated sphere, whether or not q's
block was evaluated for the tile.

The TPU kernel chunks patches at 4096 rows and rays at its SMEM list budget
and reads neighbour rows from permuted copies of the table; all three are
TPU memory workarounds that change no candidate.  K2 takes the whole table
in one launch, culls each tile's blocks itself and reads q's row through
its id.

`sweep_winner` launches csrc/winner.cu for CUDA tensors and calls
`sweep_winner_reference` for CPU tensors; it never falls back from one to
the other.
"""
from __future__ import annotations

import torch

from ..bezier.patches import BezierPatches
from . import cuda_sweep as cs
from . import intersect as ix

# (ray, patch) pairs per chunk of the plain twin: K1's twin's working set
# (16,384 rays at P_pad 512), whatever P is
_REFERENCE_CHUNK_PAIRS = cs._REFERENCE_CHUNK_R * 512


def sweep_winner_reference(patches: BezierPatches, start, direction,
                           use_aabb: bool = True):
    """Plain PyTorch version of K2: (any_hit [R], win [R] i32, win_dist [R]).

    Dense `sweep_codes` over every (ray, patch) pair, in the mode config
    asks for (`intersect.sweep_mode()`); direct candidates and
    voters only where the pair is evaluated (listed and gated, as in K1;
    use_aabb as in `cuda_sweep.tile_block_lists`); K2's retry rule; then the
    min distance, lowest id on ties.  Rays go in chunks of whole tiles,
    about _REFERENCE_CHUNK_PAIRS pairs each."""
    R = start.shape[0]
    P = patches.num_patches
    rays_t = cs.pad_rays(start.to(torch.float32), direction.to(torch.float32))
    patch_t = cs.pack_patch_table(patches)
    listed = cs.listed_blocks(
        *cs.tile_block_lists(patches, rays_t, use_aabb=use_aabb), patch_t.shape[0])
    nb = patches.neighbours.to(device=start.device, dtype=torch.int64).clamp(0, P - 1)

    mode = ix.sweep_mode()
    tiles_per_chunk = max(1, _REFERENCE_CHUNK_PAIRS // (cs.TILE_R * P))
    outs = []
    for t0 in range(0, listed.shape[0], tiles_per_chunk):
        rt = rays_t[:, t0 * cs.TILE_R:(t0 + tiles_per_chunk) * cs.TILE_R]
        sphere = cs.sphere_hit_pairs(patch_t, rt)
        keep = cs.evaluated_pairs(listed[t0:t0 + tiles_per_chunk], sphere)[:, :P]
        cs.count_twin_pairs("winner", keep)
        sphere = sphere[:, :P]
        code, dist = ix.sweep_codes(patches, rt[0:3].T, rt[3:6].T, mode)
        what_off = code & 7
        what_on = torch.where(keep & ((code >> 3) > 0), what_off, ix.WHAT_NONE)
        voted = torch.zeros(code.shape, dtype=torch.int32, device=code.device)
        for s in range(3):
            voted.index_add_(1, nb[:, s], (what_on == s).to(torch.int32))
        considered = (what_on == ix.WHAT_INTERSECT) | (
            (voted > 0) & (what_off == ix.WHAT_INTERSECT) & sphere)
        key = torch.where(considered, dist, ix._BIG)
        best = key.argmin(dim=-1)  # first minimal index: lowest id on ties
        best_key = key.gather(-1, best[:, None])[:, 0]
        outs.append((best_key < ix._BIG, best.to(torch.int32), best_key))
    return tuple(torch.cat(o)[:R] for o in zip(*outs))


# ---------------------------------------------------------------------------
# the kernel: load, launch
# ---------------------------------------------------------------------------

def prepare_inputs(patches: BezierPatches, start, direction,
                   use_aabb: bool = True, tables=None) -> cs.KernelInputs:
    """K2's tables: K1's (`cuda_sweep.prepare_inputs`), with the neighbour
    ids clipped to [0, P) by the table kernel (padding rows are never
    read); tables: the patches' clamped `cuda_tables.PatchTables` at
    BLOCK_P, where the caller built them."""
    return cs._inputs(patches, start, direction, use_aabb, cs.BLOCK_P, tables, True)


def launch(inputs: cs.KernelInputs, lists: bool = False,
           pairs: bool = False) -> cs.KernelOutputs:
    """One launch of K2 on the current stream over tables from
    `prepare_inputs`, in the mode config asks for
    (`cuda_sweep.launch_kernel`)."""
    return cs.launch_kernel("winner", inputs, lists, pairs)


def sweep_winner(patches: BezierPatches, start, direction, use_aabb: bool = True,
                 tables=None):
    """K2 wrapper: (any_hit [R] bool, win [R] i32, win_dist [R] f32).

    CPU tensors go to `sweep_winner_reference`; CUDA tensors launch
    csrc/winner.cu; both in the mode config asks for
    (`intersect.sweep_mode()`); use_aabb as in `cuda_sweep.tile_block_lists`; tables as
    in `prepare_inputs` (the twin checks them and builds its own).  There
    is no fallback between the two: a build or launch failure raises."""
    if not start.is_cuda:
        if tables is not None:
            cs.check_tables(tables, patches, cs.BLOCK_P, True)
        return sweep_winner_reference(patches, start, direction, use_aabb)
    out = launch(prepare_inputs(patches, start, direction, use_aabb, tables))
    R = start.shape[0]
    best = out.dist[:R]
    return best < cs._BIG_F * 0.5, out.win[:R], best

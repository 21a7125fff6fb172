"""The sweep kernels' tables on the GPU: the table kernel, its wrapper and
its plain PyTorch version.

Everything K1, K2 and K3 read about the patches, from the leaves of a
`BezierPatches`: the row-major [P_pad, 64] patch table, the [P_pad / block_p,
12] block bounds the kernels cull by, and the [P_pad, 3] neighbour table.
On the TPU these come from XLA functions of cbtr_tpu/ops/pallas_sweep.py
(`pack_patch_table`, `patch_spheres`, `_patch_boxes`, `_block_spheres_cr`),
fused by the compiler into the jitted step.  Here their plain versions are
about 90 small device ops a call, twice a train step; csrc/tables.cu builds
the three tables in one launch, bit-equal to the plain versions (their f32
expressions in their order, no contraction).

`build_tables` launches csrc/tables.cu for CUDA patches and calls
`build_tables_reference` for CPU patches; it never falls back from one to
the other.  The winner search runs without gradients on detached patches
(`intersect.intersect_rays`), so the tables carry none.
"""
from __future__ import annotations

import ctypes

import torch

from ..bezier.patches import BezierPatches
from . import cuda_sweep as cs

# the float leaves the kernel reads, in its argument order
_FLOAT_LEAVES = ("control_points", "underlying", "bary_inverse", "heights",
                 "deriv_b", "dividers")


def build_tables_reference(patches: BezierPatches, block_p: int = cs.BLOCK_P):
    """Plain PyTorch version of the table kernel: (patch_t [P_pad, 64] f32,
    bounds [P_pad / block_p, 12] f32, nb [P_pad, 3] i32) from
    `cuda_sweep.pack_patch_table`, `cuda_sweep.block_bounds` (one
    `patch_spheres` for both) and the neighbour fill, -1 on padding rows."""
    P = patches.num_patches
    spheres = cs.patch_spheres(patches)
    patch_t = cs.pack_patch_table(patches, spheres)
    bounds = cs.block_bounds(patches, block_p, spheres)
    nb = torch.full((patch_t.shape[0], 3), -1, dtype=torch.int32, device=patches.device)
    nb[:P] = patches.neighbours.to(torch.int32)
    return patch_t, bounds, nb


def launch(patches: BezierPatches, block_p: int = cs.BLOCK_P):
    """One launch of the table kernel on the current stream.  The patches
    are f32 CUDA tensors: the plain versions compute in the patches' type
    and cast to f32 afterwards, which a cast before the kernel would not
    round like, and no caller hands a kernel wrapper anything else."""
    device = patches.device
    if block_p <= 0 or cs._PATCH_PAD % block_p:
        raise ValueError(f"block_p must divide {cs._PATCH_PAD}, got {block_p}")
    P = patches.num_patches
    if P <= 0:
        raise ValueError("no patches")
    leaves = []
    for name in _FLOAT_LEAVES:
        leaf = getattr(patches, name)
        if leaf.dtype != torch.float32 or leaf.device != device or leaf.shape[0] != P:
            raise ValueError(
                f"{name}: the table kernel takes f32 leaves of {P} patches on "
                f"{device}, got {leaf.dtype} {tuple(leaf.shape)} on {leaf.device}; "
                "the plain versions (`build_tables_reference`) take any float type")
        leaves.append(leaf.contiguous())
    if patches.neighbours.device != device or patches.neighbours.shape != (P, 3):
        raise ValueError(f"neighbours: expected ({P}, 3) on {device}, got "
                         f"{tuple(patches.neighbours.shape)} on {patches.neighbours.device}")
    if device.type != "cuda":
        raise ValueError(f"the table kernel runs on CUDA tensors, got {device}; on "
                         "the CPU its plain version computes the same function")
    neighbours = patches.neighbours.to(torch.int32).contiguous()

    P_pad = P + (-P) % cs._PATCH_PAD
    patch_t = torch.empty((P_pad, cs._N_ROWS), dtype=torch.float32, device=device)
    bounds = torch.empty((P_pad // block_p, cs._N_BOUNDS), dtype=torch.float32,
                         device=device)
    nb = torch.empty((P_pad, 3), dtype=torch.int32, device=device)

    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib = cs.load_library("tables", [vp] * 10 + [ci] * 3 + [vp])
    with torch.cuda.device(device):
        rc = lib.cbtr_tables(
            *(leaf.data_ptr() for leaf in leaves), neighbours.data_ptr(),
            patch_t.data_ptr(), bounds.data_ptr(), nb.data_ptr(),
            P, P_pad, block_p, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tables kernel launch failed: "
                           f"{lib.cbtr_cuda_error_string(rc).decode()} ({rc})")
    build_tables.launches += 1
    return patch_t, bounds, nb


def build_tables(patches: BezierPatches, block_p: int = cs.BLOCK_P):
    """Table-kernel wrapper: (patch_t [P_pad, 64] f32, bounds [P_pad /
    block_p, 12] f32, nb [P_pad, 3] i32) at the caller's block size (16 for
    K1 and K2, 32 for K3).

    CPU patches go to `build_tables_reference`; CUDA patches launch
    csrc/tables.cu (f32 leaves only: anything else raises).  There is no
    fallback between the two: a build or launch failure raises.
    `build_tables.launches` counts the kernel's launches."""
    if not patches.control_points.is_cuda:
        return build_tables_reference(patches, block_p)
    return launch(patches, block_p)


build_tables.launches = 0

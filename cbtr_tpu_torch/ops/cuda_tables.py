"""The sweep kernels' tables on the GPU: the table kernel and the ray-pack
kernel, their wrappers and their plain PyTorch versions.

Everything K1, K2 and K3 read about the patches, from the leaves of a
`BezierPatches`: the row-major [P_pad, 64] patch table, the [P_pad / block_p,
12] block bounds the kernels cull by, the [P_pad, 3] neighbour table and the
[P_pad, 8] per-patch boxes of K1's per-pair test (K2 and K3 do not read
them); and the [8, R_pad] ray table of a chunk's rays.  On the TPU these come from XLA
functions of cbtr_tpu/ops/pallas_sweep.py (`pack_patch_table`,
`patch_spheres`, `_patch_boxes`, `_block_spheres_cr`, the callers'
`rays.T`), fused by the compiler into the jitted step.  Here their plain
versions are about 90 small device ops a table build and 5 a ray table;
csrc/tables.cu builds the four tables in one launch into one workspace
(`_workspace_plan`), and the ray table in another, each bit-equal to the
plain versions (their f32 expressions in their order, no contraction).

The tables are a function of the detached patches alone, so the main path
builds them once a lens a trace (`intersect.winner_tables`, called by
`optics.lens.trace_through_lens` for both refractions and by
`intersect.intersect_rays` before its chunk loop) and hands the
`PatchTables` down to every chunk's `prepare_inputs`; a chunk then costs
one ray-pack launch before its kernel.  No cache is kept: a caller whose
patches change (the design step rebuilds them every step) builds anew.

`build_tables` launches csrc/tables.cu for CUDA patches and calls
`build_tables_reference` for CPU patches; `pack_rays` launches its kernel
for CUDA rays and calls `cuda_sweep.pad_rays` for CPU rays.  Neither falls
back from one to the other.  The winner search runs without gradients on
detached patches (`intersect._winner_chunk`), so the tables carry none.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..bezier.patches import BezierPatches
from . import cuda_lib
from . import cuda_sweep as cs

# the float leaves the kernel reads, in its argument order
_FLOAT_LEAVES = ("control_points", "underlying", "bary_inverse", "heights",
                 "deriv_b", "dividers")

# the fields of the plan cbtr_tables reads (csrc/tables.cu Field), in order:
# the padded rows, the tables' byte offsets in the workspace, its least size
PLAN_FIELDS = ("P_pad", "patch_t", "bounds", "nb", "boxes", "nbytes")
_ALIGN = 256

# cbtr_tables' parameters: 7 leaves, the workspace, its bytes, the plan, P,
# block_p, clamp, the stream; cbtr_pack_rays': start, direction, rays_t, R,
# R_pad, the stream
_VP, _CI, _CL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_TABLES_ARGTYPES = [_VP] * 8 + [_CL, ctypes.POINTER(_CL)] + [_CI] * 3 + [_VP]
_PACK_ARGTYPES = [_VP] * 3 + [_CI] * 2 + [_VP]


@dataclasses.dataclass(frozen=True)
class PatchTables:
    """The kernels' tables for one lens (`build_tables`): K1 and K2 take them
    at block 16 (K2 with `clamped` neighbours), K3 at block 32; only K1
    reads `boxes`.  On the card the four tensors are views of one
    workspace.  Unpacks as (patch_t, bounds, nb)."""

    patch_t: torch.Tensor   # [P_pad, 64] f32
    bounds: torch.Tensor    # [P_pad / block_p, 12] f32 (`cuda_sweep.block_bounds`)
    nb: torch.Tensor        # [P_pad, 3] i32: -1 on padding, or clamped to [0, P)
    boxes: torch.Tensor     # [P_pad, 8] f32 (`cuda_sweep.patch_box_table`)
    num_patches: int
    block_p: int = cs.BLOCK_P
    clamped: bool = False

    def __iter__(self):
        return iter((self.patch_t, self.bounds, self.nb))


@dataclasses.dataclass(frozen=True)
class WorkspacePlan:
    """One table build's workspace, from (P, block_p) alone: the padded rows
    and each table's byte offset (256-byte aligned), and the bytes in all."""

    P_pad: int
    block_p: int
    patch_t: int
    bounds: int
    nb: int
    boxes: int
    nbytes: int

    def as_c_array(self):
        return (ctypes.c_longlong * len(PLAN_FIELDS))(*(getattr(self, f) for f in PLAN_FIELDS))


@functools.lru_cache(maxsize=64)
def _workspace_plan(num_patches: int, block_p: int = cs.BLOCK_P) -> WorkspacePlan:
    """The workspace of one build for num_patches >= 1 at block_p (a divisor
    of 128): the patch table, the bounds, the neighbours and the boxes, in
    that order, each at a 256-byte aligned offset."""
    P, block_p = int(num_patches), int(block_p)
    if P <= 0:
        raise ValueError("no patches")
    if block_p <= 0 or cs._PATCH_PAD % block_p:
        raise ValueError(f"block_p must divide {cs._PATCH_PAD}, got {block_p}")
    P_pad = P + (-P) % cs._PATCH_PAD
    offsets, end = [], 0
    for nbytes in (4 * P_pad * cs._N_ROWS, 4 * (P_pad // block_p) * cs._N_BOUNDS,
                   4 * P_pad * 3, 4 * P_pad * cs._N_BOX):
        offsets.append(end)
        end += -(-nbytes // _ALIGN) * _ALIGN
    return WorkspacePlan(P_pad, block_p, *offsets, end)


def _views(workspace: torch.Tensor, plan: WorkspacePlan):
    """(patch_t, bounds, nb, boxes): the plan's tables as views of the workspace
    (a uint8 vector at a 256-byte aligned address, at least plan.nbytes
    long), each carved by one `as_strided`: the views are made once a
    build, on the host, so they are kept few."""
    f32 = workspace[:plan.nbytes].view(torch.float32)
    i32 = f32.view(torch.int32)
    base = f32.storage_offset()
    return (f32.as_strided((plan.P_pad, cs._N_ROWS), (cs._N_ROWS, 1), base + plan.patch_t // 4),
            f32.as_strided((plan.P_pad // plan.block_p, cs._N_BOUNDS), (cs._N_BOUNDS, 1),
                           base + plan.bounds // 4),
            i32.as_strided((plan.P_pad, 3), (3, 1), base + plan.nb // 4),
            f32.as_strided((plan.P_pad, cs._N_BOX), (cs._N_BOX, 1), base + plan.boxes // 4))


def build_tables_reference(patches: BezierPatches, block_p: int = cs.BLOCK_P,
                           clamp: bool = False) -> PatchTables:
    """Plain PyTorch version of the table kernel: patch_t [P_pad, 64] f32,
    bounds [P_pad / block_p, 12] f32, nb [P_pad, 3] i32 and boxes [P_pad,
    8] f32 from `cuda_sweep.pack_patch_table`, `cuda_sweep.block_bounds`,
    `cuda_sweep.patch_box_table` (one `patch_spheres` for all three) and
    the neighbour fill, -1 on padding rows; clamp: every id clamped to [0,
    P) (K2's table)."""
    P = patches.num_patches
    spheres = cs.patch_spheres(patches)
    patch_t = cs.pack_patch_table(patches, spheres)
    bounds = cs.block_bounds(patches, block_p, spheres)
    boxes = cs.patch_box_table(patches, spheres)
    nb = torch.full((patch_t.shape[0], 3), -1, dtype=torch.int32, device=patches.device)
    nb[:P] = patches.neighbours.to(torch.int32)
    if clamp:
        nb = nb.clamp(0, P - 1)
    return PatchTables(patch_t, bounds, nb, boxes, P, block_p, clamp)


def _table_leaves(patches: BezierPatches):
    """The kernel's inputs: the f32 leaves and the i32 neighbours, on one
    CUDA device, contiguous; raises on anything else."""
    device, P = patches.device, patches.num_patches
    leaves = []
    for name in _FLOAT_LEAVES:
        leaf = getattr(patches, name)
        if leaf.dtype != torch.float32 or leaf.device != device or leaf.shape[0] != P:
            raise ValueError(
                f"{name}: the table kernel takes f32 leaves of {P} patches on "
                f"{device}, got {leaf.dtype} {tuple(leaf.shape)} on {leaf.device}; "
                "the plain versions (`build_tables_reference`) take any float type")
        leaves.append(leaf.contiguous())
    nb = patches.neighbours
    if nb.device != device or nb.shape != (P, 3) or nb.dtype.is_floating_point:
        raise ValueError(f"neighbours: expected integer ({P}, 3) on {device}, got "
                         f"{nb.dtype} {tuple(nb.shape)} on {nb.device}")
    if device.type != "cuda":
        raise ValueError(f"the table kernel runs on CUDA tensors, got {device}; on "
                         "the CPU its plain version computes the same function")
    return leaves, nb.to(torch.int32).contiguous()


def launch(patches: BezierPatches, block_p: int = cs.BLOCK_P,
           clamp: bool = False) -> PatchTables:
    """One launch of the table kernel on the current stream, into one new
    uint8 workspace of `_workspace_plan(P, block_p).nbytes` (the build's one
    allocation; the C entry point refuses a short or misaligned one).  The
    patches are f32 CUDA tensors: the plain versions compute in the
    patches' type and cast to f32 afterwards, which a cast before the
    kernel would not round like, and no caller hands a kernel wrapper
    anything else."""
    plan = _workspace_plan(patches.num_patches, block_p)
    device = patches.device
    leaves, neighbours = _table_leaves(patches)
    workspace = torch.empty(plan.nbytes, dtype=torch.uint8, device=device)
    cuda_lib.call("tables", _TABLES_ARGTYPES, device,
                  *(leaf.data_ptr() for leaf in leaves), neighbours.data_ptr(),
                  workspace.data_ptr(), workspace.numel(), plan.as_c_array(),
                  patches.num_patches, block_p, int(clamp))
    return PatchTables(*_views(workspace, plan), patches.num_patches, block_p, clamp)


def build_tables(patches: BezierPatches, block_p: int = cs.BLOCK_P,
                 clamp: bool = False) -> PatchTables:
    """Table-kernel wrapper: the `PatchTables` at the caller's block size (16
    for K1 and K2, 32 for K3), the neighbours clamped to [0, P) when clamp
    (K2).

    CPU patches go to `build_tables_reference`; CUDA patches launch
    csrc/tables.cu (f32 leaves only: anything else raises).  There is no
    fallback between the two: a build or launch failure raises."""
    if not patches.control_points.is_cuda:
        return build_tables_reference(patches, block_p, clamp)
    return launch(patches, block_p, clamp)


def launch_pack_rays(start, direction) -> torch.Tensor:
    """One launch of the ray-pack kernel on the current stream: the [8,
    R_pad] f32 ray table of `cuda_sweep.pad_rays` from contiguous f32 [R, 3]
    CUDA starts and directions."""
    R = start.shape[0]
    for t, name in ((start, "start"), (direction, "direction")):
        if t.dtype != torch.float32 or t.dim() != 2 or tuple(t.shape) != (R, 3) \
                or not t.is_contiguous() or t.device != start.device:
            raise ValueError(f"{name}: the ray-pack kernel takes contiguous f32 [{R}, 3] "
                             f"tensors on {start.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device} (contiguous={t.is_contiguous()})")
    device = start.device
    if device.type != "cuda":
        raise ValueError(f"the ray-pack kernel runs on CUDA tensors, got {device}; on "
                         "the CPU its plain version (`cuda_sweep.pad_rays`) computes "
                         "the same function")
    R_pad = R + (-R) % cs.TILE_R
    rays_t = torch.empty((8, R_pad), dtype=torch.float32, device=device)
    cuda_lib.call("pack_rays", _PACK_ARGTYPES, device,
                  start.data_ptr(), direction.data_ptr(), rays_t.data_ptr(), R, R_pad)
    return rays_t


def pack_rays(start, direction) -> torch.Tensor:
    """Ray-pack wrapper: the [8, R_pad] f32 ray table (rows sx, sy, sz, dx,
    dy, dz, 0, 0; padding rays s = 0, d = (1, 0, 0)).

    CPU rays go to `cuda_sweep.pad_rays`; CUDA rays launch csrc/tables.cu's
    ray-pack kernel (contiguous f32 [R, 3] only: anything else raises).
    There is no fallback between the two."""
    if not start.is_cuda:
        return cs.pad_rays(start, direction)
    return launch_pack_rays(start, direction)

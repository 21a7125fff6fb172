"""Fused sweep + select on the GPU: the CUDA kernel K1, its wrapper and its
plain PyTorch twin.

Counterpart of the fused path of cbtr_tpu/ops/pallas_sweep.py
(`_sweep_select_kernel` / `sweep_select_pallas`).  For every ray it returns
the winner of reference/bezierMesh.cpp:206-227's scan with one forward
retry: (any_hit [R] bool, win [R] i32, win_dist [R] f32), min distance,
lowest patch id on ties, without materialising per-pair state.

The candidate set is defined at (128-ray tile x 16-patch block)
granularity, as on the TPU:

* `tile_block_lists` lists, per tile, the ascending ids of the blocks whose
  merged bounding sphere AND union AABB some ray of the tile hits;
* inside a listed block, the block is evaluated for all 128 rays when ANY
  (patch, ray) pair of block x tile passes the per-patch sphere test;
* pairs of unlisted or ungated blocks produce no candidate (code
  WHAT_NONE), which is part of the semantics: gating per pair would drop
  retry candidates the reference computes (they converge up to 66x the
  hull radius out).

`sweep_select` launches csrc/sweep_select.cu for CUDA tensors and calls
`sweep_select_reference` for CPU tensors; it never falls back from one to
the other.  The kernel is built with nvcc at first use (no import-time
work: importing this module needs no nvcc).
"""
from __future__ import annotations

import ctypes
import dataclasses
import glob
import os
import shutil
import subprocess
import threading

import torch

from ..bezier.patches import BezierPatches
from ..config import DEFAULT as CFG
from . import intersect as ix

# feature-column layout of the row-major [P, 64] patch table
_ROW_CP = 0        # 30 cols: control point k at cols (3k, 3k+1, 3k+2)
_ROW_PLANE = 30    # 4 cols: underlying plane nx, ny, nz, c
_ROW_BINV = 34     # 9 cols: barycentric inverse, row-major
_ROW_H = 43        # 2 cols: heights (inside, outside)
_ROW_DB = 45       # 3 cols: second derivative direction
_ROW_DIV = 48      # 12 cols: 3 divider planes x (nx, ny, nz, c)
_ROW_BSPHERE = 60  # 4 cols: bounding sphere cx, cy, cz, radius (inflated)
_N_ROWS = 64

TILE_R = 128       # rays per tile (one CUDA block, one thread per ray)
BLOCK_P = 16       # patches per candidate block (FUSED_BLOCK_P)
_PATCH_PAD = 128   # patch-table padding (every block size divides it)

# largest patch count of the fused path, as in the JAX package; above it
# the reference runs the winner kernel K2 (`_winner_kernel`), not ported yet
_FUSED_MAX_P = 1024

# ray chunk of the plain twin: bounds its [chunk, P] working set (a few GB
# at P = 450 with every Newton temporary alive)
_REFERENCE_CHUNK_R = 16384

_BIG_F = ix._BIG


# ---------------------------------------------------------------------------
# host-side tables (plain tensor ops, shared by the kernel and its twin)
# ---------------------------------------------------------------------------


def _seq_sum(x, dim: int):
    """Left-to-right sum along `dim` (fixed order, like XLA's reduce loop)."""
    parts = x.unbind(dim)
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


def _norm3(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def patch_spheres(patches: BezierPatches):
    """Per-patch bounding sphere over the control net (surface inside the
    convex hull of the 10 control points), inflated 25%: (center [P,3],
    radius [P]).  The inflation is empirical; see the JAX package's
    patch_spheres for the measurements behind it."""
    cp = patches.control_points
    # a true division (a Python scalar divisor would multiply by 1/10)
    center = _seq_sum(cp, 1) / torch.full_like(cp[:, 0, :], 10.0)
    radius = _norm3(cp - center[:, None, :]).amax(dim=-1) * 1.25 + 1e-5
    return center, radius


def _patch_boxes(cp, center, radius):
    """Per-patch AABB: control-net box expanded per axis by the sphere's
    slack (radius - r_hull).  Padding rows are excluded downstream by their
    radius 0."""
    r_hull = _norm3(cp - center[:, None, :]).amax(dim=-1)
    slack = (radius - r_hull).clamp_min(0.0)[:, None]
    return cp.amin(dim=1) - slack, cp.amax(dim=1) + slack


def _ray_aabb_hit(lo, hi, s, d):
    """Slab test: do rays (s, d) [R,3] hit boxes [B,3]?  Returns [R,B] bool.
    Zero direction components become +-1e-30 so the slab arithmetic stays
    finite with the exact parallel-ray semantics."""
    d_safe = torch.where(d.abs() < 1e-30, torch.where(d < 0.0, -1e-30, 1e-30), d)
    inv = 1.0 / d_safe                                          # [R,3]
    t1 = (lo[None, :, :] - s[:, None, :]) * inv[:, None, :]     # [R,B,3]
    t2 = (hi[None, :, :] - s[:, None, :]) * inv[:, None, :]
    tmin = torch.minimum(t1, t2).amax(dim=-1)                   # [R,B]
    tmax = torch.maximum(t1, t2).amin(dim=-1)
    return (tmax >= 0.0) & (tmin <= tmax)


def _block_spheres_cr(center, radius):
    """Merged sphere per BLOCK_P-patch block from per-patch (center [Pp,3],
    radius [Pp]) whose row count is a BLOCK_P multiple; padding rows have
    radius <= 0.  Returns ([B,3], [B]) with radius < 0 for all-padding
    blocks."""
    cb = center.reshape(-1, BLOCK_P, 3)
    rb = radius.reshape(-1, BLOCK_P)
    real = rb > 0.0
    denom = real.sum(dim=1).clamp_min(1).to(torch.float32)
    c = _seq_sum(torch.where(real[..., None], cb, 0.0), 1) / denom[:, None]
    reach = _norm3(cb - c[:, None, :]) + rb
    return c, torch.where(real, reach, -1.0).amax(dim=1)


def _pad_rows(x, rows: int):
    return torch.cat([x, x.new_zeros((rows - x.shape[0],) + x.shape[1:])])


def tile_block_lists(patches: BezierPatches, rays_t):
    """Per-128-ray-tile candidate block lists.

    rays_t [8, R_pad] (rows sx, sy, sz, dx, dy, dz, 0, 0).  Returns
    (counts [T] i32, lists [B, T] i32): lists[:counts[t], t] are the ids of
    the blocks whose merged sphere AND union-of-patch-AABBs are hit by at
    least one ray of tile t, ascending.  A dense [R_pad, B] test, then a
    stable sort."""
    center, radius = patch_spheres(patches)
    P = patches.num_patches
    P_pad = P + (-P) % _PATCH_PAD
    lo, hi = _patch_boxes(patches.control_points, center, radius)
    center, radius = _pad_rows(center, P_pad), _pad_rows(radius, P_pad)
    lo, hi = _pad_rows(lo, P_pad), _pad_rows(hi, P_pad)

    c, r = _block_spheres_cr(center, radius)            # [B,3], [B]
    s = rays_t[0:3, :].T                                # [R_pad, 3]
    d = rays_t[3:6, :].T
    rel = c[None, :, :] - s[:, None, :]                 # [R_pad, B, 3]
    t_ca = (rel[..., 0] * d[:, None, 0] + rel[..., 1] * d[:, None, 1]
            + rel[..., 2] * d[:, None, 2])
    rel2 = rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1] + rel[..., 2] * rel[..., 2]
    r2 = (r * r)[None, :]
    hit = ((rel2 - t_ca * t_ca) <= r2) & ((t_ca >= 0.0) | (rel2 <= r2))
    hit = hit & (r >= 0.0)[None, :]                     # all-padding blocks
    real = (radius > 0.0).reshape(-1, BLOCK_P)          # [B, BLOCK_P]
    lob = torch.where(real[..., None], lo.reshape(-1, BLOCK_P, 3), torch.inf).amin(dim=1)
    hib = torch.where(real[..., None], hi.reshape(-1, BLOCK_P, 3), -torch.inf).amax(dim=1)
    hit = hit & _ray_aabb_hit(lob, hib, s, d)
    tile_hit = hit.reshape(-1, TILE_R, hit.shape[-1]).any(dim=1)    # [T,B]
    counts = tile_hit.sum(dim=-1).to(torch.int32)
    lists = torch.argsort((~tile_hit).to(torch.uint8), dim=-1, stable=True)
    return counts, lists.T.contiguous().to(torch.int32)


def pack_patch_table(patches: BezierPatches) -> torch.Tensor:
    """Row-major [P_pad, 64] f32 feature table (layout: the _ROW_* columns);
    padding rows are all zero (zero normal -> WHAT_NONE, radius 0 -> never
    listed)."""
    P = patches.num_patches
    center, radius = patch_spheres(patches)
    rows = torch.cat(
        [
            patches.control_points.reshape(P, 30),
            patches.underlying,
            patches.bary_inverse.reshape(P, 9),
            patches.heights,
            patches.deriv_b,
            patches.dividers.reshape(P, 12),
            center,
            radius[:, None],
        ],
        dim=-1,
    ).to(torch.float32)
    return _pad_rows(rows, P + (-P) % _PATCH_PAD).contiguous()


def pad_rays(start, direction) -> torch.Tensor:
    """[8, R_pad] f32 ray table (rows sx, sy, sz, dx, dy, dz, 0, 0), R padded
    to a TILE_R multiple with rays s = 0, d = (1, 0, 0)."""
    R = start.shape[0]
    R_pad = R + (-R) % TILE_R
    rays = torch.zeros((R_pad, 8), dtype=torch.float32, device=start.device)
    rays[:R, 0:3] = start
    rays[:R, 3:6] = direction
    rays[R:, 3] = 1.0
    return rays.T.contiguous()


def _sphere_hit_pairs(patch_t, rays_t):
    """Per-(ray, patch) bounding-sphere test [R, P_pad] over the packed table
    (the expression csrc/sweep_select.cu::sphere_hit evaluates)."""
    bc = patch_t[:, _ROW_BSPHERE:_ROW_BSPHERE + 4]
    sx, sy, sz = (rays_t[k, :, None] for k in range(3))
    dx, dy, dz = (rays_t[k, :, None] for k in range(3, 6))
    relx, rely, relz = bc[:, 0] - sx, bc[:, 1] - sy, bc[:, 2] - sz
    t_ca = relx * dx + rely * dy + relz * dz
    rel2 = relx * relx + rely * rely + relz * relz
    r2 = bc[:, 3] * bc[:, 3]
    return ((rel2 - t_ca * t_ca) <= r2) & ((t_ca >= 0.0) | (rel2 <= r2))


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------


def sweep_select_reference(patches: BezierPatches, start, direction,
                           cull: bool = True):
    """Plain PyTorch version of K1: (any_hit [R], win [R] i32, win_dist [R]).

    cull=True computes the kernel's function: per-pair `_candidates_core`
    codes, pairs outside the listed-and-gated (tile x block) set forced to
    WHAT_NONE, then `select_candidates`.  cull=False is `sweep_codes`
    followed by `select_candidates` over every pair (the JAX package's XLA
    path).  Rays are processed in chunks of _REFERENCE_CHUNK_R."""
    R = start.shape[0]
    P = patches.num_patches
    start = start.to(torch.float32)
    direction = direction.to(torch.float32)
    if not cull:
        outs = [
            ix.select_candidates(
                *ix.sweep_codes(patches, start[r0:r0 + _REFERENCE_CHUNK_R],
                                direction[r0:r0 + _REFERENCE_CHUNK_R]),
                patches.neighbours,
            )
            for r0 in range(0, R, _REFERENCE_CHUNK_R)
        ]
        return tuple(torch.cat(o) for o in zip(*outs))

    rays_t = pad_rays(start, direction)
    patch_t = pack_patch_table(patches)
    P_pad = patch_t.shape[0]
    B = P_pad // BLOCK_P
    counts, lists = tile_block_lists(patches, rays_t)
    T = counts.shape[0]
    slot = torch.arange(B, device=counts.device)[:, None]          # [B,1]
    listed = torch.zeros((T, B), dtype=torch.bool, device=counts.device)
    listed[torch.arange(T, device=counts.device).expand(B, T)[slot < counts],
           lists.long()[slot < counts]] = True

    tiles_per_chunk = _REFERENCE_CHUNK_R // TILE_R
    outs = []
    for t0 in range(0, T, tiles_per_chunk):
        t1 = min(t0 + tiles_per_chunk, T)
        rt = rays_t[:, t0 * TILE_R:t1 * TILE_R]
        gated = _sphere_hit_pairs(patch_t, rt).reshape(
            t1 - t0, TILE_R, B, BLOCK_P).any(dim=3).any(dim=1)      # [tc,B]
        keep = (listed[t0:t1] & gated)[:, None, :, None].expand(
            t1 - t0, TILE_R, B, BLOCK_P).reshape(-1, P_pad)[:, :P]
        code, dist = ix.sweep_codes(patches, rt[0:3].T, rt[3:6].T)
        code = torch.where(keep, code, ix.WHAT_NONE)
        outs.append(ix.select_candidates(code, dist, patches.neighbours))
    return tuple(torch.cat(o)[:R] for o in zip(*outs))


# ---------------------------------------------------------------------------
# the kernel: build, load, launch
# ---------------------------------------------------------------------------

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "cbtr_tpu_torch")
_LIB_NAME = "libcbtr_tpu_torch_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no FMA contraction, IEEE sqrt and division: the kernel's candidate
    # arithmetic stays bit-identical to the plain twin's separate torch ops
    "-fmad=false", "-prec-sqrt=true", "-prec-div=true",
    "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with nvcc "
                       "at first use on a machine with the CUDA toolkit")


def build_library() -> str:
    """Compile csrc/*.cu with NVCC_FLAGS into the build directory when the
    library is missing or older than a source.  Returns nvcc's output (empty
    when the library was up to date)."""
    sources = sorted(glob.glob(os.path.join(_CSRC_DIR, "*.cu")))
    headers = glob.glob(os.path.join(_CSRC_DIR, "*.cuh"))
    lib_path = os.path.join(BUILD_DIR, _LIB_NAME)
    newest = max(os.path.getmtime(f) for f in sources + headers)
    if os.path.exists(lib_path) and os.path.getmtime(lib_path) >= newest:
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return proc.stdout + proc.stderr


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            build_library()
            lib = ctypes.CDLL(os.path.join(BUILD_DIR, _LIB_NAME))
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.cbtr_sweep_select.restype = ci
            lib.cbtr_sweep_select.argtypes = (
                [vp] * 7 + [ci] * 5 + [cf] * 4 + [ci, vp]
            )
            lib.cbtr_cuda_error_string.restype = ctypes.c_char_p
            lib.cbtr_cuda_error_string.argtypes = [ci]
            _lib = lib
        return _lib


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


@dataclasses.dataclass(frozen=True)
class KernelInputs:
    """Everything one launch of K1 reads, built by `prepare_inputs`."""

    counts: torch.Tensor    # [T] i32 listed blocks per tile
    lists: torch.Tensor     # [B, T] i32 listed block ids, ascending
    rays_t: torch.Tensor    # [8, R_pad] f32
    patch_t: torch.Tensor   # [P_pad, 64] f32
    nb: torch.Tensor        # [P_pad, 3] i32 neighbour ids, -1 on padding
    num_patches: int


def prepare_inputs(patches: BezierPatches, start, direction) -> KernelInputs:
    """The kernel's tables (plain tensor ops on the rays' device)."""
    device = start.device
    if patches.device != device or direction.device != device:
        raise ValueError("patches, start and direction must share one device")
    P = patches.num_patches
    rays_t = pad_rays(start.to(torch.float32), direction.to(torch.float32))
    patch_t = pack_patch_table(patches)
    nb = torch.full((patch_t.shape[0], 3), -1, dtype=torch.int32, device=device)
    nb[:P] = patches.neighbours.to(torch.int32)
    counts, lists = tile_block_lists(patches, rays_t)
    return KernelInputs(counts, lists, rays_t, patch_t, nb, P)


def launch(inputs: KernelInputs):
    """One launch of K1 on the current stream: (win_dist [R_pad] f32,
    win [R_pad] i32), BIG (3.4e38) and 0 for a miss."""
    device = inputs.rays_t.device
    R_pad, P_pad = inputs.rays_t.shape[1], inputs.patch_t.shape[0]
    T, B = R_pad // TILE_R, P_pad // BLOCK_P
    if inputs.num_patches > _FUSED_MAX_P or R_pad % TILE_R or P_pad % _PATCH_PAD:
        raise ValueError(f"unsupported shape: P = {inputs.num_patches}, "
                         f"R_pad = {R_pad}, P_pad = {P_pad}")
    for t, name, dtype, shape in (
        (inputs.counts, "counts", torch.int32, (T,)),
        (inputs.lists, "lists", torch.int32, (B, T)),
        (inputs.rays_t, "rays_t", torch.float32, (8, R_pad)),
        (inputs.patch_t, "patch_t", torch.float32, (P_pad, _N_ROWS)),
        (inputs.nb, "neighbours", torch.int32, (P_pad, 3)),
    ):
        _check(t, name, dtype, shape, device)
    dist = torch.empty(R_pad, dtype=torch.float32, device=device)
    idx = torch.empty(R_pad, dtype=torch.int32, device=device)

    lib = _library()
    with torch.cuda.device(device):
        rc = lib.cbtr_sweep_select(
            inputs.counts.data_ptr(), inputs.lists.data_ptr(),
            inputs.rays_t.data_ptr(), inputs.patch_t.data_ptr(),
            inputs.nb.data_ptr(), dist.data_ptr(), idx.data_ptr(),
            T, inputs.num_patches, P_pad, BLOCK_P,
            int(CFG.root_search_iterations),
            CFG.ray_plane_intersection_epsilon,
            CFG.intersection_estimation_epsilon,
            CFG.max_intersection_distance_from_ray,
            CFG.minimal_ray_distance,
            int(CFG.clamp_secant_estimate),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"sweep_select kernel launch failed: "
            f"{lib.cbtr_cuda_error_string(rc).decode()} ({rc})")
    sweep_select.launches += 1
    return dist, idx


def sweep_select(patches: BezierPatches, start, direction):
    """K1 wrapper: (any_hit [R] bool, win [R] i32, win_dist [R] f32).

    CPU tensors go to `sweep_select_reference` (cull=True); CUDA tensors
    launch csrc/sweep_select.cu.  There is no fallback between the two: a
    build or launch failure raises, and so does P > _FUSED_MAX_P on the GPU
    (that range belongs to the winner kernel K2, not ported yet).
    `sweep_select.launches` counts the kernel's launches."""
    if not start.is_cuda:
        return sweep_select_reference(patches, start, direction)
    P = patches.num_patches
    if P > _FUSED_MAX_P:
        raise NotImplementedError(
            f"P = {P} > {_FUSED_MAX_P}: the GPU path for this patch count is "
            "kernel K2 (cbtr_tpu/ops/pallas_sweep.py::_winner_kernel), which "
            "is not ported yet")
    dist, idx = launch(prepare_inputs(patches, start, direction))
    R = start.shape[0]
    best = dist[:R]
    return best < _BIG_F * 0.5, idx[:R], best


sweep_select.launches = 0

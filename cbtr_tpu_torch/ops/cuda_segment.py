"""Fixed-order segment sums on the GPU: the segment-sum kernel, its wrapper,
its plain PyTorch version and the two autograd Functions built on them.

`segment_sum(ids, vals, num_segments)` adds the rows of vals [N, C] into
num_segments rows by their ids [N]; ids outside [0, num_segments) are
dropped (the JAX splat's `mode="drop"`).  Two sums of the port run through
it, both scatter-adds in the JAX package that XLA runs in a fixed order:
the recompute's table gradient, its per-ray [R, 60] row gradients added
into the table's rows (cbtr_tpu/ops/intersect.py:331 `jnp.take`'s
gradient: the recompute kernels' backward, and `gather_rows`, the plain
recompute's row gather in place of `torch.index_select`), and the splat's
scatter path (cbtr_tpu/render/render.py:95 `img.at[].add`).
On the card torch's `index_add_` adds with float atomics, so its result
moves with thread scheduling; this sum does not.

**The order.**  A segment's rows are taken in ascending source index and
summed as a GROUP-ary tree (GROUP = 256): level 0 folds each run of GROUP
consecutive rows of the segment from +0.0, left to right; level k folds
each run of GROUP consecutive level-(k-1) partials of the segment the same
way, until one value is left.  An empty segment is +0.0.  So a segment of at
most GROUP rows is the plain left fold that a sequential `index_add_` into
zeros performs (the CPU's), and a fold from +0.0 turns a lone -0.0 into
+0.0, as that one does.  The long segments stay parallel on the card: misses
gather patch 0 (about 85 % of a 4K chunk's rows) and dead rays splat at the
image centre.

`segment_sum` launches csrc/segment_sum.cu for CUDA tensors (f32 values)
and calls `segment_sum_reference`, which repeats the order, for CPU
tensors; there is no fallback from one to the other, and a failed build or
launch raises.  `segment_sum.launches` counts the kernel's launches (one a
sum, whatever its number of stages).  On the card the rows are grouped by
the kernel's own stable radix sort on the bits the segment count needs, and
the offsets and node bases are computed on the device, all enqueued by one
C call into one workspace sized on the host (`_workspace_plan`): the CUDA
path calls no `torch.sort`, `searchsorted` or `cumsum` and reads nothing
back.  The plain version groups by a stable `torch.sort` (`_grouping`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
from torch.autograd.function import once_differentiable

from ..utils.profiling import span

# children a node of the tree folds (csrc/segment_sum.cu GROUP)
GROUP = 256


def _grouping(ids, num_segments: int):
    """(sorted keys [N] i32, perm [N] i64, offsets [S + 1] i64): the rows
    grouped by segment in ascending source index (a stable sort of int32
    keys, dropped ids keyed S so they sort last), and each segment's first
    position in perm (offsets[S]: the rows kept)."""
    ids = ids.reshape(-1)
    keep = (ids >= 0) & (ids < num_segments)
    keys = torch.where(keep, ids, num_segments).to(torch.int32)
    sorted_keys, perm = torch.sort(keys, stable=True)
    offsets = torch.searchsorted(
        sorted_keys, torch.arange(num_segments + 1, dtype=torch.int32, device=ids.device))
    return sorted_keys, perm, offsets


def _levels(n_rows: int) -> int:
    """Levels of the tree: enough that GROUP ** levels >= n_rows, the longest
    a segment can be."""
    levels, span = 1, GROUP
    while span < n_rows:
        levels, span = levels + 1, span * GROUP
    return levels


def _node_bases(counts, levels: int):
    """[levels, S + 1] i64: row k holds the prefix sums over the segments of
    their nodes at level k.  A segment takes part in level k while the level
    below left it more than one value (level 0: while it has rows), with
    ceil(count / GROUP ** (k + 1)) nodes."""
    dev = counts.device
    span = GROUP ** torch.arange(levels + 1, dtype=torch.int64, device=dev)
    floor = torch.where(torch.arange(levels, device=dev) == 0, 0, span[:levels])
    n = counts[None, :]
    nodes = torch.where(n > floor[:, None], (n + span[1:, None] - 1) // span[1:, None], 0)
    bases = torch.zeros((levels, counts.shape[0] + 1), dtype=torch.int64, device=dev)
    bases[:, 1:] = torch.cumsum(nodes, dim=1)
    return bases


def _max_nodes(n_rows: int, num_segments: int, level: int) -> int:
    """An upper bound on the nodes of `level`, from the sizes alone: each
    taking segment adds at most one rounded-up node to its share of the
    rows, and at level k > 0 only segments of more than GROUP ** k rows
    take part."""
    below = GROUP ** level
    taking = min(num_segments, n_rows if level == 0 else n_rows // below)
    return n_rows // (below * GROUP) + taking + 1


# the kernel's radix sort (csrc/segment_sum.cu): tiles of TILE keys, each
# ranked by SORT_WARPS warps over runs of 32 x SORT_ITEMS keys in rounds of
# 32 lanes; a histogram block counts `subs` tiles, more as N grows (up to
# MAX_SUBS, keeping at least _MIN_HISTOGRAM_BLOCKS blocks: the card has 132
# SMs); digits of at most MAX_DIGIT_BITS bits; the scans take SCAN_TILE
# elements a block
SORT_WARPS = 8
SORT_ITEMS = 16
TILE = SORT_WARPS * 32 * SORT_ITEMS
MAX_SUBS = 8
_MIN_HISTOGRAM_BLOCKS = 512
MAX_DIGIT_BITS = 11
SCAN_TILE = 8192
_ALIGN = 256
_INT32_MAX = 2**31 - 1

# the fields of the plan the C entry point reads (csrc/segment_sum.cu Field),
# in order: byte offsets into the workspace, and the sizes they were made for
PLAN_FIELDS = (
    "passes", "width0", "width1", "width2", "tiles", "subs", "levels",
    "nodes0", "nodes1", "nodes2", "nodes3",
    "memset", "tickets", "status0", "status1", "status2", "status3",
    "scan_blocks0", "scan_blocks1", "scan_blocks2", "scan_blocks3",
    "counts", "offsets", "node_bases", "keys0", "payload0", "keys1", "payload1",
    "scratch0", "scratch1",
)


@dataclasses.dataclass(frozen=True)
class WorkspacePlan:
    """The kernel's stages and workspace for one (N, S, C), from the sizes
    alone.  bits: ceil(log2(S + 1)), the key bits (a dropped row is keyed
    S); widths: the digit bits of each sort pass; tiles: ceil(N / TILE);
    subs: the tiles a histogram block counts; levels and max_nodes: the
    tree's levels and a bound on each level's nodes (the fold's grids);
    scan_blocks: blocks of each digit scan, then of the node scan; fields:
    PLAN_FIELDS' values; nbytes: the workspace."""
    bits: int
    widths: tuple
    tiles: int
    subs: int
    levels: int
    max_nodes: tuple
    scan_blocks: tuple
    fields: dict
    nbytes: int

    def as_c_array(self):
        return (ctypes.c_longlong * len(PLAN_FIELDS))(*(self.fields[f] for f in PLAN_FIELDS))


@functools.lru_cache(maxsize=64)
def _workspace_plan(n_rows: int, num_segments: int, columns: int) -> WorkspacePlan:
    """The plan of one segment sum of n_rows x columns values into
    num_segments >= 1 segments (a pure function of the sizes: nothing is
    read from the device).  The workspace holds, each at a 256-byte aligned
    offset: the scans' tickets and look-back words (the only bytes the
    kernel clears), the digit counts [digits x tiles] of the widest pass,
    the offsets [S + 1] and node bases [levels x (S + 1)] (int32), the keys
    and payloads of the sort (keys only in a multi-pass sort: its last pass
    leaves the sorted keys for the offsets; two buffers of each beyond one
    pass), and two scratch buffers of level partials when the tree has
    more than one level.  Raises ValueError above the int32 positions the
    kernel keeps (2^31 - 1 rows, node ids, segments)."""
    N, S, C = int(n_rows), int(num_segments), int(columns)
    if N < 0 or C < 1:
        raise ValueError(f"need n_rows >= 0 and columns >= 1, got {N}, {C}")
    if N > _INT32_MAX:
        raise ValueError(f"the segment-sum kernel keeps int32 row positions: {N} rows "
                         f"exceed 2^31 - 1")
    if not 1 <= S < _INT32_MAX:
        raise ValueError(f"num_segments must lie in [1, 2^31 - 1), got {S}")
    bits = S.bit_length()                      # ceil(log2(S + 1))
    passes = -(-bits // MAX_DIGIT_BITS)
    widths = tuple(bits // passes + (1 if p < bits % passes else 0) for p in range(passes))
    tiles = -(-N // TILE)
    subs = max(1, min(MAX_SUBS, tiles // _MIN_HISTOGRAM_BLOCKS))
    levels = _levels(N)
    max_nodes = tuple(min(_max_nodes(N, S, k), max(N, 1)) for k in range(levels))
    if sum(max_nodes) + levels > _INT32_MAX or levels * (S + 1) > _INT32_MAX:
        raise ValueError(f"{N} rows into {S} segments exceed the kernel's int32 node ids")
    scans = [(1 << w) * tiles for w in widths] + [levels * (S + 1)]
    scan_blocks = tuple(-(-n // SCAN_TILE) for n in scans)

    fields = dict.fromkeys(PLAN_FIELDS, 0)
    fields.update(passes=passes, tiles=tiles, subs=subs, levels=levels)
    for p, w in enumerate(widths):
        fields[f"width{p}"] = w
    for k, m in enumerate(max_nodes):
        fields[f"nodes{k}"] = m
    for q, b in enumerate(scan_blocks):
        fields[f"scan_blocks{q}"] = b
    end = 0

    def take(name, nbytes):
        nonlocal end
        fields[name] = end
        end += -(-nbytes // _ALIGN) * _ALIGN

    take("tickets", 4 * 4)
    for q, b in enumerate(scan_blocks):
        take(f"status{q}", 8 * b)
    fields["memset"] = end
    take("counts", 4 * (1 << max(widths)) * tiles)
    take("offsets", 4 * (S + 1))
    take("node_bases", 4 * levels * (S + 1))
    buffers = 1 if passes == 1 else 2
    for b in range(buffers):
        if passes > 1:
            take(f"keys{b}", 4 * N)
        take(f"payload{b}", 4 * N)
    for b in range(2):
        take(f"scratch{b}", 4 * max_nodes[0] * C if levels > 1 else 0)
    # a buffer the stages never use points at the end (its size is 0)
    for name in ("keys0", "keys1", "payload1"):
        if fields[name] == 0:
            fields[name] = end
    return WorkspacePlan(bits, widths, tiles, subs, levels, max_nodes, scan_blocks, fields, end)


def _check(ids, vals, num_segments: int):
    if vals.dim() != 2:
        raise ValueError(f"vals must be [N, C], got {tuple(vals.shape)}")
    if ids.dim() != 1 or ids.shape[0] != vals.shape[0]:
        raise ValueError(f"ids must be [N] = [{vals.shape[0]}], got {tuple(ids.shape)}")
    if ids.dtype.is_floating_point or ids.dtype == torch.bool or ids.is_complex():
        raise ValueError(f"ids must be integers, got {ids.dtype}")
    if ids.device != vals.device:
        raise ValueError(f"ids on {ids.device}, vals on {vals.device}")
    if not 0 <= num_segments < 2**31 - 1:
        raise ValueError(f"num_segments must lie in [0, 2^31 - 1), got {num_segments}")


def segment_sum_reference(ids, vals, num_segments: int):
    """Plain PyTorch version of the kernel: [S, C] in vals' type, the rows
    of each segment added in the module's order, level by level, vectorized
    across nodes (a node's children padded with +0.0 after its last one,
    which leaves a fold from +0.0 unchanged)."""
    _check(ids, vals, num_segments)
    N, C = vals.shape
    out = torch.zeros((num_segments, C), dtype=vals.dtype, device=vals.device)
    if N == 0 or C == 0 or num_segments == 0:
        return out
    sorted_keys, perm, offsets = _grouping(ids, num_segments)
    kept = int(offsets[-1])
    bases = _node_bases(offsets[1:] - offsets[:-1], _levels(N))
    items = vals.index_select(0, perm[:kept])
    item_seg = sorted_keys[:kept].to(torch.int64)
    item_base = offsets
    for base in bases:
        G = int(base[-1])
        if G == 0:
            break
        pos = torch.arange(items.shape[0], device=vals.device) - item_base[item_seg]
        taking = base[item_seg + 1] > base[item_seg]
        node = base[item_seg] + pos // GROUP
        width = int(pos[taking].max()) + 1 if bool(taking.any()) else 1
        width = min(width, GROUP)
        padded = torch.zeros((G * width, C), dtype=vals.dtype, device=vals.device)
        padded[(node * width + pos % GROUP)[taking]] = items[taking]
        padded = padded.view(G, width, C)
        acc = torch.zeros((G, C), dtype=vals.dtype, device=vals.device)
        for p in range(width):
            acc = acc + padded[:, p]
        node_seg = torch.searchsorted(base, torch.arange(G, device=vals.device),
                                      right=True) - 1
        final = base[node_seg + 1] - base[node_seg] == 1
        out[node_seg[final]] = acc[final]
        items, item_seg, item_base = acc, node_seg, base
    return out


# cbtr_segment_sum's parameters: ids, id bytes, vals, out, workspace, N, S,
# C, plan, the stream
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
             ctypes.c_void_p]


def _enqueue(lib, ids, vals, num_segments: int, stream):
    """What `launch` does after its checks, on vals' device: the zeroed
    output, one workspace of the plan's size and one call of the C entry
    point, which enqueues every stage on `stream`.  Returns (out, whether it
    called the library): nothing to add for N, C or S of 0.  Int32 and int64
    ids go as they are (other integer types are widened first)."""
    N, C = vals.shape
    S = num_segments
    out = torch.zeros((S, C), dtype=torch.float32, device=vals.device)
    if N == 0 or C == 0 or S == 0:
        return out, False
    plan = _workspace_plan(N, S, C)
    if ids.dtype not in (torch.int32, torch.int64):
        ids = ids.to(torch.int64)
    ids, vals = ids.contiguous(), vals.contiguous()
    workspace = torch.empty(plan.nbytes, dtype=torch.uint8, device=vals.device)
    with span("cbtr.launch.segment_sum"):
        rc = lib.cbtr_segment_sum(ids.data_ptr(), ids.element_size(), vals.data_ptr(),
                                  out.data_ptr(), workspace.data_ptr(), N, S, C,
                                  plan.as_c_array(), stream)
    if rc != 0:
        raise RuntimeError(f"segment-sum kernel launch failed: "
                           f"{lib.cbtr_cuda_error_string(rc).decode()} ({rc})")
    return out, True


def launch(ids, vals, num_segments: int):
    """One segment sum on the kernel, on the current stream: vals an f32
    CUDA tensor [N, C], ids an integer tensor [N] on its device."""
    # the library loader lives beside the sweep kernels, which import
    # intersect, which imports this module
    from . import cuda_sweep as cs

    _check(ids, vals, num_segments)
    if vals.device.type != "cuda":
        raise ValueError(f"the segment-sum kernel runs on CUDA tensors, got {vals.device}; "
                         "on the CPU its plain version computes the same function")
    if vals.dtype != torch.float32:
        raise ValueError(f"the segment-sum kernel adds f32 values, got {vals.dtype}")
    lib = cs.load_library("segment_sum", _ARGTYPES)
    with torch.cuda.device(vals.device):
        out, launched = _enqueue(lib, ids, vals, num_segments,
                                 torch.cuda.current_stream(vals.device).cuda_stream)
    if launched:
        segment_sum.launches += 1
    return out


def _sum(ids, vals, num_segments: int):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if vals.is_cuda:
        return launch(ids, vals, num_segments)
    return segment_sum_reference(ids, vals, num_segments)


class _SegmentSum(torch.autograd.Function):
    """segment_sum; its backward gathers the output's gradient (0 for a
    dropped row)."""

    @staticmethod
    def forward(ctx, vals, ids, num_segments):
        ctx.save_for_backward(ids)
        ctx.num_segments = num_segments
        return _sum(ids, vals, num_segments)

    @staticmethod
    @once_differentiable
    @span("cbtr.backward.segment_sum")
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        keep = (ids >= 0) & (ids < ctx.num_segments)
        rows = torch.index_select(grad, 0, torch.where(keep, ids, 0))
        return torch.where(keep[:, None], rows, 0.0), None, None


class _GatherRows(torch.autograd.Function):
    """index_select(table, 0, idx); its backward is the segment sum of the
    incoming rows into the table's rows."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return torch.index_select(table, 0, idx)

    @staticmethod
    @once_differentiable
    @span("cbtr.backward.gather_rows")
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None
        (idx,) = ctx.saved_tensors
        shape = ctx.table_shape
        flat = grad.reshape(grad.shape[0], -1).contiguous()
        return _sum(idx, flat, shape[0]).reshape(shape), None


def segment_sum(ids, vals, num_segments: int):
    """out [S, C] with out[s] the sum of vals[r] over ids[r] == s, in the
    module's fixed order; ids outside [0, S) are dropped.  Differentiable in
    vals (the gradient of a row is the gradient of its segment).  CUDA
    tensors launch csrc/segment_sum.cu (f32 only: anything else raises), CPU
    tensors run `segment_sum_reference`."""
    return _SegmentSum.apply(vals, ids, num_segments)


def gather_rows(table, idx):
    """table[idx] along dim 0, bit for bit `torch.index_select`, whose
    gradient into table is a `segment_sum` of the incoming rows (in place of
    `index_select`'s atomic `index_add_` on the card).  idx [N] integer in
    [0, table.shape[0])."""
    return _GatherRows.apply(table, idx)


segment_sum.launches = 0

"""The point source's ray synthesis on the GPU: the wrapper of the CUDA kernel
csrc/emitter.cu.

One launch makes the rays of `render/emitters.py::synthesize` at any global
indices: each ray's three Threefry-2x32 hashes, its bin and its float tail
in registers, and only the rays written (start, direction [N, 3] and
weight [N], f32, 28 B a ray).  It reads the emitter's bin tables as
`DeviceEmitter._device_tables` holds them on the card, built once an
emitter.  The plain version is `render/emitters.py::synthesize_reference`,
which `synthesize` runs for CPU tensors; this wrapper takes CUDA tensors
only and raises on anything else.  There is no fallback between the two.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib

_MASK = 0xFFFFFFFF
# the per-bin tables the kernel reads (`DeviceEmitter._tables`'s keys): the
# bins' bounds, first rays and ray counts, then their floats
_INT_TABLES = ("bounds", "starts", "nb")
_FLOAT_TABLES = ("cos_a", "cos_b", "turn0", "turn_w", "frac")

_vp, _ll, _ci, _cu, _cf = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint,
                           ctypes.c_float)
# cbtr_emitter's parameters: idx, its stride, n, 8 tables, the bins, the key
# words, the origin, n_rays, the three outputs, the stream (`cuda_lib.call`
# passes it)
_ARGTYPES = [_vp, _ll, _ll] + [_vp] * 8 + [_ci, _cu, _cu] + [_cf] * 4 + [_vp] * 4


def check_inputs(tables, idx) -> int:
    """Raise unless the kernel takes these: idx a 1-D int64 tensor (any
    stride), the tables 1-D, contiguous, of one length, int64 bounds,
    starts and nb and f32 floats, on idx's device, and that device a card.
    Returns the bins."""
    if idx.dtype != torch.int64 or idx.dim() != 1:
        raise ValueError(f"idx: the emitter kernel takes a 1-D int64 tensor, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    num_bins = tables["bounds"].shape[0]
    for names, dtype in ((_INT_TABLES, torch.int64), (_FLOAT_TABLES, torch.float32)):
        for name in names:
            cuda_lib.check_tensor(tables[name], name, dtype, (num_bins,), idx.device)
    if num_bins == 0:
        raise ValueError("the emitter has no bins")
    if idx.device.type != "cuda":
        raise ValueError(f"the emitter kernel runs on CUDA tensors, got {idx.device}; on "
                         "the CPU its plain version (`emitters.synthesize_reference`) "
                         "computes the same rays")
    return num_bins


def entry_args(tables, idx, seed: int, origin, n_rays: int, outputs) -> tuple:
    """cbtr_emitter's arguments (`_ARGTYPES`) for these inputs and the
    outputs (start, direction, weight), all but the stream."""
    return (idx.data_ptr(), idx.stride(0), idx.shape[0],
            *(tables[name].data_ptr() for name in _INT_TABLES + _FLOAT_TABLES),
            tables["bounds"].shape[0], 0, int(seed) & _MASK,
            *(float(o) for o in origin), float(n_rays),
            *(t.data_ptr() for t in outputs))


def launch(tables, idx, seed: int, origin, n_rays: int):
    """One launch of the emitter kernel on the current stream: (start
    [N, 3], direction [N, 3], weight [N]) f32, contiguous, for the global
    ray indices idx [N] of the emitter with these bin tables, seed, origin
    and ray count (`cuda_lib.call`)."""
    check_inputs(tables, idx)
    device, n = idx.device, idx.shape[0]
    outputs = (torch.empty((n, 3), dtype=torch.float32, device=device),
               torch.empty((n, 3), dtype=torch.float32, device=device),
               torch.empty(n, dtype=torch.float32, device=device))
    cuda_lib.call("emitter", _ARGTYPES, device,
                  *entry_args(tables, idx, seed, origin, n_rays, outputs))
    return outputs

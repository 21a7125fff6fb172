"""The emitter kernel (csrc/emitter.cu) against its plain version
(`render/emitters.py::synthesize_reference`), on the CPU.

The kernel's source is built for the host with g++ (no contraction), each
launch a loop over its blocks and the kernel a loop over a block's threads
for each phase between `__syncthreads()` calls, and called with the
arguments `ops/cuda_emitter.py` passes it (`entry_args`).  Its draws, bins,
index in the bin and the bin's rays (its `draw` function, called for each
index) equal the plain version's, and so do the starts and the weights.
Each direction component lies within one ulp of 1.0 of the plain
version's, the unit vector's scale (the components' own ulps are counted
and printed: the host's sinf, cosf and sqrtf against torch's CPU ones,
which round other ways on a few per cent of inputs, and the norm's sum
added as torch adds it on the card, not fused as on the CPU), and equals
it where the plain version rounds as on the card: the same expressions in
the same order.  Whole blocks and a ragged last one, a non-contiguous index and a
rank's slice against the same slice of the whole set.  The wrapper raises on what the kernel does not take, and the
layer sends CPU tensors to the plain version without launching.
"""
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cbtr_tpu_torch.ops import cuda_emitter, cuda_lib
from cbtr_tpu_torch.render import emitters

torch.set_num_threads(2)

ORIGIN = (2.0, 0.25, -0.5)
SEED_ABOVE_32_BITS = (1 << 32) + 12345

_HOST_HEADER = r"""
#pragma once
#include <cmath>
#include <cstring>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline unsigned __funnelshift_l(unsigned lo, unsigned hi, unsigned s) {
  s &= 31;
  return s ? (hi << s) | (lo >> (32 - s)) : hi;
}
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
struct HostIndex { unsigned x; };
static HostIndex threadIdx, blockIdx;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
"""
# each index's `draw`, and the host's sinf, cosf and sqrtf over an array, for
# the test (appended after the source's namespace)
_DRAWS = r"""
extern "C" void host_libm(int which, const float* x, float* out, long long n) {
  for (long long i = 0; i < n; ++i)
    out[i] = which == 0 ? sinf(x[i]) : (which == 1 ? cosf(x[i]) : sqrtf(x[i]));
}

extern "C" void host_draws(const long long* idx, long long n, const long long* bounds,
                           const long long* starts, const long long* nb, int num_bins,
                           unsigned key0, unsigned key1, float* u, long long* bin, float* j,
                           float* cnt) {
  EmitterArgs a{};
  a.bounds = bounds;
  a.starts = starts;
  a.nb = nb;
  a.num_bins = num_bins;
  a.key0 = key0;
  a.key1 = key1;
  for (long long i = 0; i < n; ++i) {
    const Draw d = draw(a, idx[i]);
    u[2 * i] = d.u0;
    u[2 * i + 1] = d.u1;
    bin[i] = d.bin;
    j[i] = d.j;
    cnt[i] = d.cnt;
  }
}
"""
_KERNEL = re.compile(r"__global__ void __launch_bounds__\((\w+)\) (\w+)\([^)]*\) \{\n")
_LAUNCH = re.compile(r"(\w+)<<<([^,]+), [^;]*?>>>")


def _host_blocks(src):
    """The source with every launch a loop over its blocks and the kernel a
    loop over a block's threads for each phase between __syncthreads()
    calls, its leading shared and const declarations once before them."""
    src, launches = _LAUNCH.subn(
        r"for (blockIdx.x = 0; blockIdx.x < \2; ++blockIdx.x) \1", src)
    assert launches == 1
    m = _KERNEL.search(src)
    end = src.index("\n}\n", m.end())
    statements = [st.strip() + ";" for st in src[m.end():end].strip().rstrip(";").split(";\n")]
    k = 0
    while statements[k].startswith(("__shared__", "const ")):
        k += 1
    phases = " ".join(statements[k:]).split("__syncthreads();")
    assert m.group(2) == "emitter_kernel" and len(phases) == 2, (m.group(2), phases)
    loops = "".join(f"\n  for (threadIdx.x = 0; threadIdx.x < {m.group(1)}; ++threadIdx.x) "
                    f"{{ {phase.strip()} }}" for phase in phases)
    return src[:m.end()] + "\n".join(statements[:k]) + loops + src[end:]


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    """csrc/emitter.cu built with g++ (no contraction) for the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's source for the host")
    tmp = tmp_path_factory.mktemp("emitter_host")
    src = open(os.path.join(os.path.dirname(cuda_emitter.__file__), os.pardir, "csrc",
                            "emitter.cu")).read()
    src = _host_blocks(src).replace("}  // namespace", "}  // namespace" + _DRAWS, 1)
    (tmp / "cuda_runtime.h").write_text(_HOST_HEADER)
    (tmp / "emitter.cpp").write_text(src)
    lib = tmp / "libemitter_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fno-fast-math",
                    "-shared", "-fPIC", "-Wno-unknown-pragmas", f"-I{tmp}", "-o", str(lib),
                    str(tmp / "emitter.cpp")], check=True, capture_output=True, timeout=600)
    out = ctypes.CDLL(str(lib))
    out.cbtr_emitter.argtypes = cuda_emitter._ARGTYPES
    out.cbtr_emitter.restype = ctypes.c_int
    return out


def _kernel_rays(lib, em, idx):
    """The host-built kernel's (start, direction, weight) at idx."""
    tables = em._device_tables(idx.device)
    n = idx.shape[0]
    outputs = (torch.full((n, 3), float("nan")), torch.full((n, 3), float("nan")),
               torch.full((n,), float("nan")))
    rc = lib.cbtr_emitter(*cuda_emitter.entry_args(tables, idx, em.seed, em.origin,
                                                   em.n_rays, outputs), None)
    assert rc == 0
    return outputs


def _kernel_draws(lib, em, idx):
    """The kernel's `draw` at each index: (u [N,2], bin [N], j [N], cnt [N])."""
    t = em._device_tables(idx.device)
    idx = idx.contiguous()
    n = idx.shape[0]
    u, j, cnt = torch.empty(n, 2), torch.empty(n), torch.empty(n)
    bins = torch.empty(n, dtype=torch.int64)
    vp = ctypes.c_void_p
    lib.host_draws.argtypes = [vp, ctypes.c_longlong] + [vp] * 3 + [
        ctypes.c_int, ctypes.c_uint, ctypes.c_uint] + [vp] * 4
    lib.host_draws(idx.data_ptr(), n, t["bounds"].data_ptr(), t["starts"].data_ptr(),
                   t["nb"].data_ptr(), t["bounds"].shape[0], 0, em.seed & 0xFFFFFFFF,
                   u.data_ptr(), bins.data_ptr(), j.data_ptr(), cnt.data_ptr())
    return u, bins, j, cnt


def _card_rounding(lib, monkeypatch):
    """The plain version's float tail rounded as on the card: torch.sin,
    torch.cos and torch.sqrt computed by the host library's sinf, cosf and
    sqrtf (the ones the host-built kernel calls), and the norm of a row of
    three added as torch adds it on the card, (x*x + z*z) + y*y (on the
    CPU torch fuses it: fma(z, z, fma(y, y, x*x)))."""
    lib.host_libm.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
    libm = {}
    for which, name in enumerate(("sin", "cos", "sqrt")):
        def fn(x, which=which):
            x = x.contiguous()
            out = torch.empty_like(x)
            lib.host_libm(which, x.data_ptr(), out.data_ptr(), x.numel())
            return out
        libm[name] = fn
        monkeypatch.setattr(torch, name, fn)

    def norm(d, dim, keepdim):
        assert dim == -1 and keepdim and d.shape[-1] == 3
        return libm["sqrt"]((d[:, 0] * d[:, 0] + d[:, 2] * d[:, 2]) + d[:, 1] * d[:, 1])[:, None]

    monkeypatch.setattr(torch.linalg, "vector_norm", norm)


def _ulps(got, want):
    """How many float32 values lie between got and want, elementwise."""
    def ordered(x):
        i = x.numpy().view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(got) - ordered(want))


def _hold(lib, em, idx, label, monkeypatch):
    """The kernel's rays at idx against the plain version's: start and
    weight equal; each direction component within one ulp of 1.0 (the unit
    vector's scale), the components' own ulps counted and printed; rounded
    as on the card (`_card_rounding`), the directions equal."""
    got = _kernel_rays(lib, em, idx)
    want = emitters.synthesize_reference(em, idx)
    for k, name in ((0, "start"), (2, "weight")):
        assert torch.equal(got[k], want[k]), (label, name)
    ulps = _ulps(got[1], want[1])
    gap = float((got[1] - want[1]).abs().max())
    print(f"{label}: direction components differing from the plain version's by 0, 1, "
          f"2, ... ulps: {np.bincount(ulps.ravel()).tolist()}; largest gap {gap:.3e}")
    assert gap <= 2.0 ** -23, (label, gap)
    with monkeypatch.context() as m:
        _card_rounding(lib, m)
        as_on_the_card = emitters.synthesize_reference(em, idx)
    for a, b in zip(got, as_on_the_card):
        assert torch.equal(a, b), label
    return got


CASES = [(4, 1000, 3), (16, 65536, SEED_ABOVE_32_BITS), (64, 65536, 2**31 + 5),
         (64, 40000, 0)]


@pytest.mark.parametrize("belts,n,seed", CASES)
def test_kernel_equals_the_plain_version(host_library, monkeypatch, belts, n, seed):
    """Every ray of the set: draws, bins, j and cnt equal; start and weight
    equal; directions within one ulp of 1.0, and equal rounded as on the
    card (whole blocks of 256 rays, and a ragged last block where n is not a
    multiple)."""
    em = emitters.DeviceEmitter(ORIGIN, belts, n, seed)
    idx = torch.arange(n)
    got = _kernel_draws(host_library, em, idx)
    want = em.bins_at(idx)
    for g, w, name in zip(got, want, ("u", "bin", "j", "cnt")):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    _hold(host_library, em, idx, f"belts {belts}, {n} rays, seed {seed}", monkeypatch)


def test_non_contiguous_indices_and_a_ranks_slice(host_library, monkeypatch):
    """A strided index (every third ray, backwards from the end, and past
    the set's last ray, where the bin clamps to the last) and a rank's
    contiguous slice give the whole set's rays at those indices."""
    em = emitters.DeviceEmitter(ORIGIN, 16, 65536, SEED_ABOVE_32_BITS)
    whole = _kernel_rays(host_library, em, torch.arange(em.n_rays))
    wide = torch.arange(em.n_rays + 600)
    strided = wide.flip(0)[::3]
    assert strided.stride(0) == 3
    _hold(host_library, em, strided, "every third index", monkeypatch)
    inside = strided[strided < em.n_rays]
    part = _kernel_rays(host_library, em, inside)
    for a, b in zip(part, whole):
        assert torch.equal(a, b[inside])
    rank = torch.arange(em.n_rays)[3 * em.n_rays // 4:]
    for a, b in zip(_kernel_rays(host_library, em, rank), whole):
        assert torch.equal(a, b[rank])


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    em = emitters.DeviceEmitter(ORIGIN, 4, 1000, 3)
    tables = em._device_tables(torch.device("cpu"))
    idx = torch.arange(10)
    with pytest.raises(ValueError, match="int64"):
        cuda_emitter.launch(tables, idx.to(torch.int32), em.seed, em.origin, em.n_rays)
    with pytest.raises(ValueError, match="1-D"):
        cuda_emitter.launch(tables, idx.view(2, 5), em.seed, em.origin, em.n_rays)
    bad = dict(tables, frac=tables["frac"].double())
    with pytest.raises(ValueError, match="frac"):
        cuda_emitter.launch(bad, idx, em.seed, em.origin, em.n_rays)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_emitter.launch(tables, idx, em.seed, em.origin, em.n_rays)
    assert cuda_lib.launch_counts()["emitter"] == 0 and "emitter" not in cuda_lib.loaded()


def test_cpu_indices_take_the_plain_version_without_launching(monkeypatch):
    em = emitters.DeviceEmitter(ORIGIN, 8, 4096, 5)
    idx = torch.arange(em.n_rays)

    def refuse(*args, **kwargs):
        raise AssertionError("the kernel was launched for CPU indices")

    monkeypatch.setattr(cuda_emitter, "launch", refuse)
    for a, b in zip(emitters.synthesize(em, idx), emitters.synthesize_reference(em, idx)):
        assert torch.equal(a, b)


def test_bin_tables_are_built_once_an_emitter():
    """Every emitter of one belt count and ray count shares one set of
    tables on a device, read-only; another ray count has its own."""
    a = emitters.DeviceEmitter(ORIGIN, 8, 4096, 5)
    b = emitters.DeviceEmitter((0.0, 1.0, 2.0), 8, 4096, 9)
    t = a._device_tables(torch.device("cpu"))
    assert t is b._device_tables(torch.device("cpu"))
    assert t is not a._replace(n_rays=4097)._device_tables(torch.device("cpu"))
    with pytest.raises(TypeError):
        t["bounds"] = None
    for k, v in a._tables().items():
        assert torch.equal(t[k], torch.as_tensor(v))

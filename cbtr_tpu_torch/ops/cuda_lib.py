"""The port's one way to build, load and call a hand-written CUDA kernel.

Each kernel is a C entry point of a shared library that nvcc builds from
one csrc/<stem>.cu (`build_library`), at first use and never at import:
importing this module needs no nvcc.  `KERNELS` is the one list of the
port's kernels: each one's counter name, source stem, C symbol and span.
`call` is one launch of one of them: the library loaded once a stem, the
C call on the current stream inside the kernel's span, a failure raised
as a `RuntimeError` (nothing falls back), and one launch counted.  The
wrappers (K1 and K2 in cuda_sweep.py, K3 in cuda_codes.py, the table and
ray-pack kernels in cuda_tables.py, the segment sum, the recompute pair,
the emitter, K4 in benchmarks/fma_peak.py) keep their own checks,
outputs and arguments.

The counts (`launch_counts`, `counted`) are those of `call`; a replayed
CUDA graph makes its launches without one, so its owner adds them
(`add_launches`).
"""
from __future__ import annotations

import ctypes
import glob
import os
import re
import shutil
import subprocess
import threading
from typing import NamedTuple

import torch

from ..utils.profiling import span

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "cbtr_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no FMA contraction, IEEE sqrt and division: the kernels' candidate
    # arithmetic stays bit-identical to the plain twins' separate torch ops
    "-fmad=false", "-prec-sqrt=true", "-prec-div=true",
    "-shared", "-Xcompiler", "-fPIC",
    # registers, shared memory and spills of every kernel (build_library's output)
    "-Xptxas", "-v",
]


class Kernel(NamedTuple):
    stem: str       # its source, csrc/<stem>.cu
    symbol: str     # its C entry point
    span: str       # the span of its C call


# every kernel of the port, by the name its launches are counted under
KERNELS = {
    "sweep_select": Kernel("sweep_select", "cbtr_sweep_select", "cbtr.launch.k1"),
    "winner": Kernel("winner", "cbtr_winner", "cbtr.launch.k2"),
    "sweep_codes": Kernel("sweep_codes", "cbtr_sweep_codes", "cbtr.launch.k3"),
    "tables": Kernel("tables", "cbtr_tables", "cbtr.launch.tables"),
    "pack_rays": Kernel("tables", "cbtr_pack_rays", "cbtr.launch.pack_rays"),
    "segment_sum": Kernel("segment_sum", "cbtr_segment_sum", "cbtr.launch.segment_sum"),
    "recompute_forward": Kernel("recompute", "cbtr_recompute",
                                "cbtr.launch.recompute_forward"),
    "recompute_backward": Kernel("recompute", "cbtr_recompute_backward",
                                 "cbtr.launch.recompute_backward"),
    "emitter": Kernel("emitter", "cbtr_emitter", "cbtr.launch.emitter"),
    "fma_chains": Kernel("fma_peak", "cbtr_fma_peak", "cbtr.launch.k4"),
}

# every loaded library by source stem (`library`), and each kernel's launches
_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}
_launches = dict.fromkeys(KERNELS, 0)


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with nvcc "
                       "at first use on a machine with the CUDA toolkit")


def library_path(stem: str) -> str:
    """The shared library built from csrc/<stem>.cu."""
    return os.path.join(BUILD_DIR, f"libcbtr_{stem}.so")


def build_library() -> str:
    """Compile each csrc/*.cu with NVCC_FLAGS into a library of its own
    (`library_path`), where it is missing or older than its source or a
    header: one nvcc per source, all started together.  Returns nvcc's
    output, each source's under a "== <source>" line (empty when every
    library was up to date); raises if any build fails."""
    sources = sorted(glob.glob(os.path.join(_CSRC_DIR, "*.cu")))
    newest_header = max((os.path.getmtime(f) for f in
                         glob.glob(os.path.join(_CSRC_DIR, "*.cuh"))), default=0.0)
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for src in sources:
        lib_path = library_path(os.path.splitext(os.path.basename(src))[0])
        newest = max(os.path.getmtime(src), newest_header)
        if os.path.exists(lib_path) and os.path.getmtime(lib_path) >= newest:
            continue
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        jobs.append((src, lib_path, tmp, proc))
    logs, failed = [], []
    for src, lib_path, tmp, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src} ({proc.returncode}):\n{err}")
        else:
            os.replace(tmp, lib_path)
            logs.append(f"== {os.path.basename(src)}\n{out}{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def _kernel_name(symbol: str) -> str:
    """A mangled kernel symbol's last name, with its int and bool template
    arguments: "sweep_select_kernel<1, true>", "recompute_forward_kernel"."""
    if not symbol.startswith("_Z"):
        return symbol
    rest, name = symbol[2:].removeprefix("N"), symbol
    while m := re.match(r"\d+", rest):
        end = m.end() + int(m.group())
        name, rest = rest[m.end():end], rest[end:]
    args = re.match(r"I((?:L[ib]\d+E)+)E", rest)
    if args:
        values = [("true" if v == "1" else "false") if t == "b" else v
                  for t, v in re.findall(r"L([ib])(\d+)E", args.group(1))]
        name += f"<{', '.join(values)}>"
    return name


def ptxas_summary(log: str) -> dict:
    """{kernel: {stack, spill_stores, spill_loads, registers, shared_bytes}}
    for every kernel in nvcc's -Xptxas -v output (`build_library`'s log),
    keyed by `_kernel_name`; a device function (no registers of its own)
    is left out."""
    out, name, row = {}, None, {}
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, row = _kernel_name(m.group(1)), {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            row.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out[name] = dict(row, registers=int(m.group(1)),
                             shared_bytes=int(smem.group(1)) if smem else 0)
            name = None
    return out


# ---------------------------------------------------------------------------
# load, call, count
# ---------------------------------------------------------------------------


def library(stem: str) -> ctypes.CDLL:
    """csrc/<stem>.cu's library, built (`build_library`) and loaded at the
    first call and kept for the next ones, with cbtr_cuda_error_string
    declared."""
    with _lock:
        lib = _libraries.get(stem)
        if lib is None:
            build_library()
            lib = ctypes.CDLL(library_path(stem))
            lib.cbtr_cuda_error_string.restype = ctypes.c_char_p
            lib.cbtr_cuda_error_string.argtypes = [ctypes.c_int]
            _libraries[stem] = lib
        return lib


def entry(stem: str, symbol: str, argtypes):
    """The C function `symbol` of csrc/<stem>.cu's library, declared at the
    first call as taking argtypes and returning an int; a later call that
    declares other argtypes raises."""
    fn = getattr(library(stem), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    elif tuple(fn.argtypes) != tuple(argtypes):
        raise TypeError(f"{symbol}: declared as taking {list(fn.argtypes)}, "
                        f"called as taking {list(argtypes)}")
    return fn


def call(name: str, argtypes, device, *args) -> None:
    """One launch of the kernel `name` (`KERNELS`) on `device`: its C entry
    point (argtypes, the stream last) called with args and the device's
    current stream, inside the kernel's span; a non-zero CUDA error code
    raises, and the launch is counted."""
    kernel = KERNELS[name]
    fn = entry(kernel.stem, kernel.symbol, argtypes)
    with torch.cuda.device(device), span(kernel.span):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{error_string(kernel.stem, rc)} ({rc})")
    _launches[name] += 1


def error_string(stem: str, rc: int) -> str:
    """The CUDA error message of code rc, from csrc/<stem>.cu's library."""
    return library(stem).cbtr_cuda_error_string(rc).decode()


def check_tensor(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless t is a contiguous tensor of this type and shape on device."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def launch_counts() -> dict:
    """{kernel: its launches so far} for every kernel of `KERNELS`."""
    return dict(_launches)


def counted(fn):
    """(fn's result, {kernel: launches fn made}): every count read just
    before fn and just after (not reset, so a caller that counts around
    this one still sees every launch)."""
    before = launch_counts()
    out = fn()
    return out, {name: n - before[name] for name, n in _launches.items()}


def add_launches(launches: dict) -> None:
    """Add {kernel: launches} to the counts: those of a CUDA graph's
    replay, which launches without `call`."""
    for name, n in launches.items():
        _launches[name] += n


def loaded() -> set:
    """The stems whose libraries are loaded."""
    return set(_libraries)

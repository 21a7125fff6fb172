"""Measured FP32 FMA peak of the card: the CUDA kernel K4, its wrapper, its
plain twin, the slope measurement and the card's physical ceiling.

Counterpart of benchmarks/vpu_peak.py ("VPU" names the TPU's vector unit).
The sweep kernels are FP32 arithmetic outside the tensor cores, so their
roofline is the card's sustained FP32 FMA rate, which this module measures
instead of assuming:

* K = 16 independent chains ``x <- a - x*x`` per element, one fused
  multiply-add per step (csrc/fma_peak.cu), chain k started at
  a * (0.1 + 0.05 k) and the chains summed, as `vpu_peak._make_kernel`;
* one element per thread over SMs x BLOCKS_PER_SM x 256 threads: the card
  filled, where the TPU kernel ran one [8, 128] tile;
* the slope between two loop lengths, N_SMALL and N_BIG, removes the fixed
  cost of a launch; each timed launch gets a fresh input (vpu_peak.py's
  rule) and is timed with CUDA events;
* `select_peak` rejects a run above the physical ceiling (`fma_ceiling`:
  SMs x 128 FP32 lanes x 2 FLOP x the SM clock the card reports) and keeps
  the maximum of the rest.  bench.py anchored on 2 x the minimum run, which
  a contended minimum turns against every genuine run.

On CPU tensors `fma_chains` runs the twin and `measure_fma_peak` times the
twin with the host clock at loop lengths 8 and 64: a rate of torch's CPU
operations, which checks the code path and measures no device.

    python -m cbtr_tpu_torch.benchmarks.fma_peak [--device cuda|cpu]

prints one JSON line: the peak of RUNS measurements, every run and the
ceiling.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import time

import torch

from ..ops import cuda_sweep as cs

K_CHAINS = 16
THREADS = 256
BLOCKS_PER_SM = 4
FP32_LANES_PER_SM = 128   # Hopper: 4 partitions x 32 FP32 lanes
# loop lengths on the card: the long launch takes >= 5 ms, the short one
# <= 1/10 of it (measured on the H100, PERF.md)
N_SMALL = 8192
N_BIG = 131072
# loop lengths at which K4 is checked against its twin.  Near its fixed point
# the map contracts by |2x*| <= 0.95 a step for a in [0.5, 0.7], so by
# N_SMALL every chain sits on x*(a), whatever its start or its step count:
# only short chains tell a wrong kernel apart (13 leaves the unrolled loop a
# remainder; 0 holds the start factors alone)
CHECK_LENGTHS = (0, 1, 8, 13, 64)
RUNS = 3             # measurements per report (max of those at or below the ceiling)
# on the CPU (the twin): enough to check the path, nothing more
_CPU_LENGTHS = (8, 64)
_CPU_ELEMENTS = 1024


def fma_chains_reference(a, n_iter: int):
    """Plain PyTorch version of K4: a [N] f32 -> [N] f32, each step rounded
    as a multiply and a subtraction (the kernel fuses them: rtol 2e-6)."""
    x = torch.stack([a * (0.1 + 0.05 * k) for k in range(K_CHAINS)])
    for _ in range(n_iter):
        x = a - x * x
    return cs._seq_sum(x, 0)


def _library() -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib = cs.load_library("fma_peak", [vp, vp, ci, ci, vp])
    lib.cbtr_sm_clock_khz.restype = ci
    lib.cbtr_sm_clock_khz.argtypes = [ci]
    return lib


def launch(a, n_iter: int):
    """One launch of K4 on the current stream: a [N] f32 (contiguous, CUDA)
    -> [N] f32."""
    if a.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA tensors, got {a.device}; on the CPU "
                         "its plain twin computes the same function")
    cs._check(a, "a", torch.float32, (a.numel(),), a.device)
    if not 0 <= n_iter < 2 ** 31:
        raise ValueError(f"n_iter out of range: {n_iter}")
    out = torch.empty_like(a)
    lib = _library()
    with torch.cuda.device(a.device):
        rc = lib.cbtr_fma_peak(a.data_ptr(), out.data_ptr(), a.numel(), n_iter,
                               torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fma_peak kernel launch failed: "
                           f"{lib.cbtr_cuda_error_string(rc).decode()} ({rc})")
    fma_chains.launches += 1
    return out


def fma_chains(a, n_iter: int):
    """K4 wrapper: CPU tensors go to `fma_chains_reference`, CUDA tensors
    launch csrc/fma_peak.cu; no fallback between the two.
    `fma_chains.launches` counts the kernel's launches."""
    if not a.is_cuda:
        return fma_chains_reference(a, n_iter)
    return launch(a, n_iter)


fma_chains.launches = 0


def chains_elements(device) -> int:
    """Elements (threads) of one measuring launch: SMs x BLOCKS_PER_SM x
    THREADS on a card."""
    device = torch.device(device)
    if device.type != "cuda":
        return _CPU_ELEMENTS
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * BLOCKS_PER_SM * THREADS


def _launch_seconds(fn, device) -> float:
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) * 1e-3


def measure_fma_peak(timing_iters: int = 5, device="cuda") -> float:
    """Sustained FP32 FMA rate in FLOP/s (slope method): 2 x K_CHAINS x
    elements x (N_BIG - N_SMALL) over the difference of the two lengths'
    median launch times, each timed launch on a fresh input."""
    device = torch.device(device)
    n_small, n_big = (N_SMALL, N_BIG) if device.type == "cuda" else _CPU_LENGTHS
    n = chains_elements(device)
    gen = torch.Generator(device=device).manual_seed(0)

    def fresh():
        return 0.5 + 0.2 * torch.rand(n, device=device, generator=gen)

    for n_iter in (n_small, n_big):     # build, load, warm
        fma_chains(fresh(), n_iter)
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    def median_seconds(n_iter):
        ts = []
        for _ in range(timing_iters):
            a = fresh()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            ts.append(_launch_seconds(lambda: fma_chains(a, n_iter), device))
        return statistics.median(ts)

    t_small, t_big = median_seconds(n_small), median_seconds(n_big)
    flops = 2 * K_CHAINS * (n_big - n_small) * n
    return flops / max(t_big - t_small, 1e-9)


def nvidia_smi(query: str) -> str:
    """The first card's line of `nvidia-smi --query-gpu=<query>
    --format=csv,noheader`."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0].strip()


def fma_ceiling(device="cuda") -> float:
    """The card's physical FP32 FMA ceiling in FLOP/s: SMs x 128 lanes x 2
    FLOP x the SM clock the card reports (cudaDevAttrClockRate)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the FMA ceiling is a property of a card, not of {device}")
    index = device.index if device.index is not None else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    khz = _library().cbtr_sm_clock_khz(index)
    if khz <= 0:
        raise RuntimeError(f"cudaDevAttrClockRate not reported for device {index}")
    return sms * FP32_LANES_PER_SM * 2.0 * khz * 1e3


def select_peak(runs, ceiling=None):
    """(peak, kept): the maximum of the runs at or below `ceiling` (all runs
    where there is no ceiling, on the CPU).  A run above it is physically
    impossible (a broken measurement) and dropped; a contended run can
    only under-measure, so the maximum of the rest is reported.  Raises
    when no run remains."""
    kept = [r for r in runs if r > 0 and (ceiling is None or r <= ceiling)]
    if not kept:
        raise RuntimeError(f"no FMA-peak run at or below the ceiling "
                           f"{ceiling}: {list(runs)}")
    return max(kept), kept


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    device = torch.device(parser.parse_args(argv).device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device here")
    runs = [measure_fma_peak(5, device) for _ in range(RUNS)]
    ceiling = fma_ceiling(device) if device.type == "cuda" else None
    peak, _ = select_peak(runs, ceiling)
    print(json.dumps({
        "metric": f"measured FP32 FMA sustained rate, {K_CHAINS}-chain slope "
                  f"method, on {device.type}",
        "value": peak / 1e12,
        "unit": "TFLOP/s",
        "runs_tflops": [r / 1e12 for r in runs],
        "ceiling_tflops": None if ceiling is None else ceiling / 1e12,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "card": nvidia_smi("name,power.limit") if device.type == "cuda" else None,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

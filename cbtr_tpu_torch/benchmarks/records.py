"""What the port's artifact scripts share: the device a script runs on, the
card fields of its record, checksums, peak device memory, timing and the
record printed as the last line of standard output.

A script runs on the card unless its caller passes --device cpu (as the
tests do).  On a CUDA device it launches the kernels or raises; there is no
quiet fall-back to the CPU.  A record made on the CPU says so ("device":
"cpu", "card": null): its times are the host's, never the card's.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import statistics
import time

import numpy as np
import torch
import torch.distributed as dist

from .fma_peak import nvidia_smi


def resolve_device(name) -> torch.device:
    """torch.device(name) (a name or a device); a CUDA device raises where
    there is none.  With a
    card, TF32 is turned off: the splat is an f32 matrix product, and TF32
    would change the image."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name}: no CUDA device here (--device cpu runs "
                               "the kernels' plain twins on the CPU and measures no device)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def card_fields(device: torch.device) -> dict:
    """The record's device fields: the device's name, the card's name and
    power limit as nvidia-smi gives them, the number of cards, and the
    ranks of the process group (1 without one)."""
    cuda = device.type == "cuda"
    return {
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "card": nvidia_smi("name,power.limit") if cuda else None,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "n_devices": dist.get_world_size() if dist.is_initialized() else 1,
    }


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def checksum(*tensors) -> str:
    """First 16 hex digits of the SHA-256 of the tensors' bytes (f32 as f32)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(np.ascontiguousarray(torch.as_tensor(t).detach().cpu().numpy()).tobytes())
    return h.hexdigest()[:16]


def reset_peak(device: torch.device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_gib(device: torch.device):
    """Peak device memory since `reset_peak` in GiB; None on the CPU (not
    measured)."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def wall_s(fn, device: torch.device):
    """(fn's result, seconds of the host clock around fn and a synchronize)."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def window_stats(fn, device: torch.device, windows: int = 5, inner: int = 2,
                 warmup: int = 1) -> dict:
    """{median_ms, min_ms, max_ms, n} of the mean time of `inner` calls over
    `windows` windows: CUDA events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    sync(device)
    times = []
    for _ in range(windows):
        if device.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(inner):
                fn()
            t1.record()
            torch.cuda.synchronize(device)
            times.append(t0.elapsed_time(t1) / inner)
        else:
            t0 = time.perf_counter()
            for _ in range(inner):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / inner)
    return {"median_ms": statistics.median(times), "min_ms": min(times),
            "max_ms": max(times), "n": windows}


@contextlib.contextmanager
def deterministic(on: bool):
    """torch's deterministic algorithms inside the block, if `on`: the
    cross-check of the default mode, which is reproducible already (the
    splat and the gather's backward are fixed-order segment sums)."""
    if not on:
        yield
        return
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def add_output_args(ap):
    """--out FILE and --label TEXT, the options every script's record takes."""
    ap.add_argument("--out", default="", help="also write the record here")
    ap.add_argument("--label", default="", help="a label copied into the record")


def emit(record: dict, out: str = "", label: str = "") -> dict:
    """Write the record (with "label", when given) to `out` (when given) and
    print it as one JSON line, last."""
    if label:
        record["label"] = label
    if out:
        with open(out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
    print(json.dumps(record), flush=True)
    return record

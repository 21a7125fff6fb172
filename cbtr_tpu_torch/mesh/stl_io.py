"""STL file reading, host-side.

Replaces the reference's stl_reader submodule (reference/mesh.cpp:399-417).
Binary format: 80-byte header, uint32 triangle count, then per triangle
12 f32 (normal + 3 vertices) + uint16 attribute = 50 bytes.
"""
from __future__ import annotations

import struct

import numpy as np


def read_stl(path: str) -> np.ndarray:
    """Read a binary or ASCII STL file -> [F, 3, 3] float32 triangle soup."""
    with open(path, "rb") as f:
        data = f.read()
    if _looks_ascii(data):
        return _read_ascii(data.decode("utf-8", errors="replace"))
    return _read_binary(data)


def _looks_ascii(data: bytes) -> bool:
    if not data.lstrip().startswith(b"solid"):
        return False
    # binary files may also start with "solid" in the header: verify size
    if len(data) >= 84:
        (count,) = struct.unpack_from("<I", data, 80)
        if len(data) == 84 + 50 * count:
            return False
    return True


def _read_binary(data: bytes) -> np.ndarray:
    if len(data) < 84:
        raise ValueError("binary STL too short")
    (count,) = struct.unpack_from("<I", data, 80)
    body = np.frombuffer(data, dtype=np.uint8, count=50 * count, offset=84)
    records = body.reshape(count, 50)
    floats = records[:, :48].copy().view(np.float32).reshape(count, 4, 3)
    return np.ascontiguousarray(floats[:, 1:4, :], dtype=np.float32)


def _read_ascii(text: str) -> np.ndarray:
    verts = []
    for line in text.splitlines():
        parts = line.split()
        if parts and parts[0] == "vertex":
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    arr = np.asarray(verts, dtype=np.float32)
    if arr.size == 0:
        return np.zeros((0, 3, 3), dtype=np.float32)
    if arr.shape[0] % 3:
        raise ValueError("ASCII STL vertex count not a multiple of 3")
    return arr.reshape(-1, 3, 3)


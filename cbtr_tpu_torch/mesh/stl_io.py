"""STL file I/O, host-side.

Replaces the reference's stl_reader submodule (reference/mesh.cpp:399-430).
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


def write_stl(path: str, triangles: np.ndarray) -> None:
    """ASCII STL writer matching Mesh::writeMesh (mesh.cpp:419-430): zeroed
    facet normals, Blender's solid name, 6 significant digits."""
    tris = np.asarray(triangles, dtype=np.float32).reshape(-1, 3, 3)
    with open(path, "w") as out:
        out.write("solid Exported from Blender-2.82 (sub 7)\n")
        for tri in tris:
            out.write("facet normal 0.000000 0.000000 0.000000\nouter loop\n")
            for vtx in tri:
                out.write(f"vertex {vtx[0]:g} {vtx[1]:g} {vtx[2]:g}\n")
            out.write("endloop\nendfacet\n")
        out.write("endsolid Exported from Blender-2.82 (sub 7)\n")


def write_stl_binary(path: str, triangles: np.ndarray) -> None:
    """Binary STL writer (compact outputs for large tessellations)."""
    tris = np.asarray(triangles, dtype=np.float32).reshape(-1, 3, 3)
    count = tris.shape[0]
    records = np.zeros((count, 50), dtype=np.uint8)
    block = np.zeros((count, 4, 3), dtype=np.float32)
    block[:, 1:4, :] = tris
    records[:, :48] = block.reshape(count, 12).view(np.uint8)
    with open(path, "wb") as out:
        out.write(b"\0" * 80)
        out.write(struct.pack("<I", count))
        out.write(records.tobytes())

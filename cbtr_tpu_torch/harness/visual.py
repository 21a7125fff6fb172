"""Visual-debug STL dumpers (reference/test.cpp:42-98).

Counterpart of cbtr_tpu/harness/visual.py, host NumPy as there.  The
reference's workflow is: dump geometry as STL, inspect in Blender.
These helpers reproduce its three visualizers so outputs remain drop-in
comparable:

* `visualize_normals`        — small tetrahedra at face centers offset along
  face normals (stand-in for the reference's spheres-on-normals,
  test.cpp:42-56; tetrahedra keep files small at equal utility)
* `visualize_vertex_normals` — same at vertices along average normals
  (test.cpp:58-73)
* `visualize_ray`            — a thin triangular prism beam (test.cpp:75-98)
"""
from __future__ import annotations

import numpy as np
import torch

from .. import geom
from ..mesh.core import TriMesh


def _marker(center: np.ndarray, size: float) -> np.ndarray:
    """Tiny tetrahedron triangle soup at `center`."""
    c = np.asarray(center, np.float32)
    v = np.array(
        [[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]], np.float32
    ) * (size * 0.5)
    faces = [(0, 1, 2), (0, 3, 1), (0, 2, 3), (1, 3, 2)]
    return np.stack([np.stack([c + v[a], c + v[b], c + v[d]]) for a, b, d in faces])


def visualize_normals(mesh: TriMesh, size_factor: float = 0.05) -> TriMesh:
    """Markers above each face center along the face normal
    (reference/test.cpp:42-56)."""
    tris = mesh.tris
    centers = tris.mean(axis=1)
    normals = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    normals /= np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-30)
    perim = (
        np.linalg.norm(tris[:, 0] - tris[:, 1], axis=-1)
        + np.linalg.norm(tris[:, 1] - tris[:, 2], axis=-1)
        + np.linalg.norm(tris[:, 2] - tris[:, 0], axis=-1)
    )
    out = [
        _marker(c + n * p * size_factor, p * size_factor)
        for c, n, p in zip(centers, normals, perim)
    ]
    return TriMesh(np.concatenate(out))


def visualize_vertex_normals(mesh: TriMesh, size_factor: float = 0.05) -> TriMesh:
    """Markers above each unique vertex along its average normal
    (reference/test.cpp:58-73); requires standardize_normals() run."""
    if mesh.vertex_average_normals is None:
        raise ValueError("run preprocess() first: no vertex average normals")
    scale = float(mesh.tris.std()) * size_factor
    out = [
        _marker(v + n * scale * 4.0, scale)
        for v, n in zip(mesh.vertices, mesh.vertex_average_normals)
    ]
    return TriMesh(np.concatenate(out))


def visualize_ray(start, direction, length: float, radius: float = 0.02) -> TriMesh:
    """Triangular prism beam along a ray (reference/test.cpp:75-98)."""
    start = np.asarray(start, np.float32)
    d = np.asarray(direction, np.float32)
    d = d / np.linalg.norm(d)
    u = geom.a_perpendicular(torch.from_numpy(d[None]))[0].numpy()
    w = np.cross(d, u)
    corners = [
        start + u * radius,
        start + (-u * 0.5 + w * 0.8660254) * radius,
        start + (-u * 0.5 - w * 0.8660254) * radius,
    ]
    far = [c + d * length for c in corners]
    tris = [np.stack([corners[0], corners[1], corners[2]]),
            np.stack([far[0], far[2], far[1]])]
    for i in range(3):
        j = (i + 1) % 3
        tris.append(np.stack([corners[i], corners[j], far[i]]))
        tris.append(np.stack([corners[j], far[j], far[i]]))
    return TriMesh(np.stack(tris))

"""The canonical mesh preprocessing sequence and the accuracy harness.

Counterpart of cbtr_tpu/harness/measure.py.  `preprocess` is the init
sequence every reference driver repeats before building patches: weld +
orient + topology + vertex averages (e.g. reference/test.cpp:261-264), on
the native C++ runtime (`cbtr_tpu_torch.native`) by default, as in the JAX
package, so both packages build their lenses from the same mesh.

`measure_approximation` re-creates measureApproximation
(reference/test.cpp:429-460): tessellate the Bezier surface built over an
ellipsoid mesh and report the mean squared relative error of the
tessellated vertices against the exact ellipsoid point at the same
spherical (azimuth, inclination).  The reference's published table
(reference/test.cpp:515-521) is the parity target.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .. import native
from ..bezier import build_from_trimesh, split_thick_patches, tessellate_to_numpy
from ..mesh.core import TriMesh, make_ellipsoid


def preprocess(mesh: TriMesh, use_native: Optional[bool] = None) -> TriMesh:
    """Weld vertices, orient normals outwards, build neighbour tables and
    vertex-average normals, in place; returns the mesh.

    Runs on the native (C++) runtime unless CBTR_NATIVE=0 or the runtime is
    unavailable (no g++), as the JAX package's `preprocess` does; the NumPy
    path (`use_native=False` forces it) stays the behavioural oracle.  An
    open mesh raises ValueError on both paths.
    """
    if use_native is None:
        use_native = (
            os.environ.get("CBTR_NATIVE", "") != "0" and native.available()
        )
    if use_native:
        tris, fellow, starts, corner_avg = native.preprocess(mesh.tris)
        mesh.tris = tris
        mesh.fellow_triangles = fellow
        mesh.fellow_common_side_starts = starts
        mesh.corner_average_normals = corner_avg
        # the per-vertex view (the visualizers read it): welded corner
        # instances are bit-identical, so exact row dedup gives the vertex
        # table, and each vertex's normal is any of its instances' normal
        uniq, first, inverse = np.unique(
            tris.reshape(-1, 3), axis=0, return_index=True, return_inverse=True
        )
        mesh.vertices = uniq.astype(np.float32)
        mesh.face2vertex = inverse.reshape(-1, 3).astype(np.int32)
        mesh.vertex_average_normals = corner_avg.reshape(-1, 3)[first]
        return mesh
    mesh.standardize_vertices()
    mesh.standardize_normals()
    return mesh


def measure_approximation(split_steps: int, sectors: int, belts: int, size,
                          divisor: int, device="cuda") -> float:
    """Mean squared relative error of the tessellated Bezier surface over
    an ellipsoid mesh (module docstring); the patches are built, split and
    tessellated on `device`."""
    size = np.asarray(size, np.float32)
    mesh = preprocess(make_ellipsoid(sectors, belts, size))

    for _ in range(split_steps):
        patches = build_from_trimesh(mesh, device=device)
        new_tris, _ = split_thick_patches(
            patches, mesh.fellow_triangles, mesh.fellow_common_side_starts
        )
        mesh = preprocess(TriMesh(new_tris))

    patches = build_from_trimesh(mesh, device=device)
    planified = TriMesh(tessellate_to_numpy(patches, divisor))
    planified.standardize_vertices()
    vertices = planified.unique_vertices()

    scaled = vertices / size
    r = np.linalg.norm(scaled, axis=-1)
    inclination = np.arccos(np.clip(scaled[:, 2] / np.maximum(r, 1e-30), -1, 1))
    azimuth = np.arctan2(scaled[:, 1], scaled[:, 0])
    ethalon = np.stack(
        [
            size[0] * np.sin(inclination) * np.cos(azimuth),
            size[1] * np.sin(inclination) * np.sin(azimuth),
            size[2] * np.cos(inclination),
        ],
        axis=-1,
    )
    num = np.sum((vertices - ethalon) ** 2, axis=-1)
    den = np.sum(ethalon**2, axis=-1)
    return float(np.mean(num / den))

"""The canonical mesh preprocessing sequence and the accuracy harness.

Counterpart of cbtr_tpu/harness/measure.py.  `preprocess` is its NumPy
branch only: every reference driver repeats weld + orient + topology +
vertex averages (e.g. reference/test.cpp:261-264) before building patches.
The JAX package's native C++ runtime agrees with this NumPy path
(tests/test_native.py); the port has no native runtime yet.

`measure_approximation` re-creates measureApproximation
(reference/test.cpp:429-460): tessellate the Bezier surface built over an
ellipsoid mesh and report the mean squared relative error of the
tessellated vertices against the exact ellipsoid point at the same
spherical (azimuth, inclination).  The reference's published table
(reference/test.cpp:515-521) is the parity target.
"""
from __future__ import annotations

import numpy as np

from ..bezier import build_from_trimesh, split_thick_patches, tessellate_to_numpy
from ..mesh.core import TriMesh, make_ellipsoid


def preprocess(mesh: TriMesh) -> TriMesh:
    """Weld vertices, orient normals outwards, build neighbour tables and
    vertex-average normals, in place; returns the mesh."""
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

"""The canonical mesh preprocessing sequence.

Counterpart of cbtr_tpu/harness/measure.py::preprocess, NumPy branch only:
every reference driver repeats weld + orient + topology + vertex averages
(e.g. reference/test.cpp:261-264) before building patches.  The JAX
package's native C++ runtime agrees with this NumPy path
(tests/test_native.py); the port has no native runtime yet.
"""
from __future__ import annotations

from ..mesh.core import TriMesh


def preprocess(mesh: TriMesh) -> TriMesh:
    """Weld vertices, orient normals outwards, build neighbour tables and
    vertex-average normals, in place; returns the mesh."""
    mesh.standardize_vertices()
    mesh.standardize_normals()
    return mesh

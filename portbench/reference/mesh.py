"""Frozen copy of `cbtr_tpu_torch/mesh/core.py` as of the benchmark's first version, for the
plain reference; it imports nothing of the port and is not kept in step with it.

Triangle-mesh preprocessing (layer L2), host-side.

Counterpart of cbtr_tpu/mesh/core.py, the same NumPy code: the port may not
import the JAX package, whose `__init__` pulls in jax.  Re-design of the
reference's `Mesh` class (reference/mesh.{h,cpp}) as a NumPy
struct-of-arrays: the mesh is an [F, 3, 3] float32 triangle soup plus
derived topology tables.  The irregular, hash/graph-heavy preprocessing
(vertex welding, neighbour topology, flood-fill normal orientation) stays on
host exactly where the reference keeps it; its outputs are the flat arrays
the Bezier construction consumes.

Pipeline parity (see SURVEY.md §3.1):
  standardize_vertices  <- mesh.cpp:72-91  (interval weld)
  standardize_normals   <- mesh.cpp:310-357 (topology + flood fill + averages)
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import DEFAULT as CFG
from . import geom
from . import stl as stl_io

# Neighbour "common side start" resolve table (mesh.cpp:216): indexed by the
# positions of this side's two vertex ids inside the fellow face.
_RESOLVE = np.array([[3, 0, 2], [0, 3, 1], [2, 1, 3]], dtype=np.int64)


class TriMesh:
    """Triangle soup + derived topology (reference `Mesh`, mesh.h:18-133)."""

    def __init__(self, tris: Optional[np.ndarray] = None):
        self.tris: np.ndarray = (
            np.zeros((0, 3, 3), np.float32)
            if tris is None
            else np.asarray(tris, np.float32).reshape(-1, 3, 3)
        )
        # topology, populated by standardize_normals()
        self.fellow_triangles: Optional[np.ndarray] = None  # [F,3] int32
        self.fellow_common_side_starts: Optional[np.ndarray] = None  # [F,3] int8
        self.face2vertex: Optional[np.ndarray] = None  # [F,3] int32 vertex ids
        self.vertices: Optional[np.ndarray] = None  # [V,3] unique welded vertices
        self.vertex_average_normals: Optional[np.ndarray] = None  # [V,3]
        # per-corner average normals [F,3,3]; set by the native preprocessing
        # runtime (cbtr_tpu_torch/native) and preferred by device_arrays when
        # present (otherwise derived from vertex_average_normals)
        self.corner_average_normals: Optional[np.ndarray] = None

    # -- container facade -------------------------------------------------
    def __len__(self) -> int:
        return self.tris.shape[0]

    # -- small queries -----------------------------------------------------
    def smallest_side(self) -> float:
        """mesh.cpp:4-12."""
        sides = self.tris - np.roll(self.tris, -1, axis=1)
        return float(np.linalg.norm(sides, axis=-1).min())

    # -- vertex welding (mesh.cpp:14-91) ------------------------------------
    def standardize_vertices(self) -> None:
        """Weld vertices closer than 0.2x the smallest side to one point.

        Same interval strategy as the reference: project all vertex instances
        onto each axis, group consecutive projections into proximity
        intervals (value - interval_start < eps), pick the axis whose largest
        interval is smallest, then weld within intervals.  Welding collapses
        each epsilon-connected cluster to its lexicographically largest
        member, which is the fixed point of the reference's pairwise
        `v1 = v2 if v1 < v2` sweep (mesh.cpp:56-70).
        """
        if len(self) == 0:
            return
        eps = self.smallest_side() * CFG.standardize_vertices_epsilon_factor
        flat = self.tris.reshape(-1, 3)

        best_axis, best_intervals, best_max = None, None, None
        for axis in range(3):
            order = np.argsort(flat[:, axis], kind="stable")
            vals = flat[order, axis]
            intervals = _proximity_intervals(vals, eps)
            max_pop = max(e - s for s, e in intervals)
            if best_max is None or max_pop < best_max:
                best_axis, best_intervals, best_max = axis, intervals, max_pop

        order = np.argsort(flat[:, best_axis], kind="stable")
        # weld on unique coordinates (instances of the same point behave
        # identically), then remap instances
        eps2 = eps * eps
        uniq, inverse = np.unique(flat, axis=0, return_inverse=True)
        parent = np.arange(len(uniq))

        def find(a: int) -> int:
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for s, e in best_intervals:
            members = np.unique(inverse[order[s:e]])
            if len(members) < 2:
                continue
            pts = uniq[members]
            d2 = np.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=-1)
            ii, jj = np.nonzero(d2 < eps2)
            for a, b in zip(members[ii], members[jj]):
                if a == b:
                    continue
                ra, rb = find(a), find(b)
                if ra != rb:
                    parent[max(ra, rb)] = min(ra, rb)

        roots = np.array([find(i) for i in range(len(uniq))])
        # representative per cluster: lexicographically largest member
        rep = {}
        order_lex = np.lexsort((uniq[:, 2], uniq[:, 1], uniq[:, 0]))
        for idx in order_lex:  # ascending; later (larger) overwrite earlier
            rep[roots[idx]] = uniq[idx]
        welded = np.stack([rep[roots[i]] for i in range(len(uniq))])
        self.tris = welded[inverse].reshape(-1, 3, 3).astype(np.float32)

    # -- topology (mesh.cpp:107-222) ----------------------------------------
    def _build_vertex_index(self) -> None:
        """Vertex dedup by exact equality (valid after welding), mesh.cpp:118-153."""
        flat = self.tris.reshape(-1, 3)
        uniq, inverse = np.unique(flat, axis=0, return_inverse=True)
        self.vertices = uniq.astype(np.float32)
        self.face2vertex = inverse.reshape(-1, 3).astype(np.int32)

    def _build_face2neighbour(self) -> None:
        """Fellow triangle + common-side-start tables (mesh.cpp:185-222)."""
        f2v = self.face2vertex
        F = len(self)
        v0 = f2v  # [F,3]
        v1 = np.roll(f2v, -1, axis=1)
        lo = np.minimum(v0, v1).ravel()
        hi = np.maximum(v0, v1).ravel()
        face_of = np.repeat(np.arange(F, dtype=np.int64), 3)
        side_of = np.tile(np.arange(3, dtype=np.int64), F)

        key = lo.astype(np.int64) * (f2v.max() + 1) + hi
        order = np.argsort(key, kind="stable")
        k_sorted = key[order]
        # each manifold edge appears exactly twice
        if len(k_sorted) % 2 or not (k_sorted[0::2] == k_sorted[1::2]).all():
            raise ValueError("Vertex on edge detected.")  # mesh.cpp:204
        a, b = order[0::2], order[1::2]
        fellow = np.empty(3 * F, dtype=np.int32)
        fellow[a] = face_of[b]
        fellow[b] = face_of[a]
        fellow = fellow.reshape(F, 3)

        # common-side-start in fellow face via the resolve table
        other = fellow.astype(np.int64)
        other_ids = f2v[other]  # [F,3,3] vertex ids of fellow faces
        pos0 = np.argmax(other_ids == v0[..., None], axis=-1)
        pos1 = np.argmax(other_ids == v1[..., None], axis=-1)
        starts = _RESOLVE[pos0, pos1]
        if (starts == 3).any():
            raise ValueError("Inconsistent neighbour topology.")
        self.fellow_triangles = fellow
        self.fellow_common_side_starts = starts.astype(np.int8)

    # -- normal orientation (mesh.cpp:224-357) --------------------------------
    def standardize_normals(self) -> None:
        """Orient all face normals outwards, then build neighbour tables and
        vertex-average normals.  Mirrors Mesh::standardizeNormals."""
        self._build_vertex_index()
        self._build_face2neighbour()
        self.corner_average_normals = None  # drop any stale native-stage stash

        # initial face: at the smallest-x vertex, most parallel to (-1,0,0)
        flat = self.tris.reshape(-1, 3)
        smallest_instance = int(np.argmin(flat[:, 0]))
        smallest_vid = int(self.face2vertex.ravel()[smallest_instance])
        faces_at = np.nonzero((self.face2vertex == smallest_vid).any(axis=1))[0]
        desired = np.array([-1.0, 0.0, 0.0], np.float32)
        normals = _face_normals(self.tris[faces_at])
        unit = normals / np.maximum(
            np.linalg.norm(normals, axis=-1, keepdims=True), 1e-30
        )
        initial = int(faces_at[np.argmax(np.abs(unit @ desired))])

        # orient the initial face (mesh.cpp:241-248)
        if float(_face_normals(self.tris[initial][None])[0] @ desired) < 0.0:
            self._swap_corners(initial, 0, 1)

        # flood fill (mesh.cpp:334-350); LIFO to match the reference queue use
        F = len(self)
        remaining = np.ones(F, dtype=bool)
        remaining[initial] = False
        stack: List[Tuple[int, int]] = [
            (initial, int(n)) for n in self.fellow_triangles[initial]
        ]
        while stack:
            known, unknown = stack.pop()
            if remaining[unknown]:
                self._normalize_against(known, unknown)
            remaining[unknown] = False
            for n in self.fellow_triangles[unknown]:
                n = int(n)
                if remaining[n] and n != unknown:
                    stack.append((unknown, n))

        # rebuild: corner swaps changed side indexing (mesh.cpp:352-355)
        self._build_vertex_index()
        self._build_face2neighbour()
        self._calculate_vertex_average_normals()

    def _swap_corners(self, face: int, i: int, j: int) -> None:
        self.tris[face, [i, j]] = self.tris[face, [j, i]]
        self.face2vertex[face, [i, j]] = self.face2vertex[face, [j, i]]

    def _normalize_against(self, known: int, unknown: int) -> None:
        """Propagate orientation from `known` to `unknown` (mesh.cpp:250-282)."""
        ids_k = self.face2vertex[known]
        ids_u = self.face2vertex[unknown]
        face_k = self.tris[known]
        face_u = self.tris[unknown]
        ik = int(np.nonzero(~np.isin(ids_k, ids_u))[0][0])
        iu = int(np.nonzero(~np.isin(ids_u, ids_k))[0][0])
        c1k, c2k = (ik + 1) % 3, (ik + 2) % 3
        c1u, c2u = (iu + 1) % 3, (iu + 2) % 3

        alt_k = _altitude(face_k[c1k], face_k[c2k], face_k[ik])
        alt_u = _altitude(face_u[c1u], face_u[c2u], face_u[iu])
        dot_alt = float(alt_k @ alt_u)
        n_k = _face_normals(face_k[None])[0]
        n_u = _face_normals(face_u[None])[0]
        dot_n = float(n_k @ n_u)
        denom = float(np.linalg.norm(n_k) * np.linalg.norm(n_u))
        if abs(dot_n / max(denom, 1e-30)) < CFG.standardize_normals_epsilon:
            # near-perpendicular: perturb the independent vertex towards the
            # known face's altitude direction and retest (mesh.cpp:265-274)
            new_indep = face_u[iu] + CFG.standardize_normals_independent_move_factor * (
                face_k[ik] - (face_k[c1k] + face_k[c2k]) / 2.0
            )
            alt_u = _altitude(face_u[c1u], face_u[c2u], new_indep)
            dot_alt = float(alt_k @ alt_u)
            moved = face_u.copy()
            moved[iu] = new_indep
            n_u = _face_normals(moved[None])[0]
            dot_n = float(n_k @ n_u)
        if dot_alt * dot_n > 0.0:
            self._swap_corners(unknown, c1u, c2u)

    def _calculate_vertex_average_normals(self) -> None:
        """Angle-weighted average of incident unit face normals per vertex
        (mesh.cpp:284-308)."""
        F = len(self)
        normals = _face_normals(self.tris)
        unit = normals / np.maximum(
            np.linalg.norm(normals, axis=-1, keepdims=True), 1e-30
        )
        side_a = np.roll(self.tris, -1, axis=1) - self.tris  # corner -> next
        side_b = np.roll(self.tris, -2, axis=1) - self.tris  # corner -> prev
        cosang = np.sum(side_a * side_b, axis=-1) / np.maximum(
            np.linalg.norm(side_a, axis=-1) * np.linalg.norm(side_b, axis=-1), 1e-30
        )
        angle = np.arccos(np.clip(cosang, -1.0, 1.0))  # [F,3]
        V = len(self.vertices)
        sums = np.zeros((V, 3), np.float64)
        np.add.at(
            sums,
            self.face2vertex.ravel(),
            (unit[:, None, :] * angle[..., None]).reshape(-1, 3),
        )
        norms = np.maximum(np.linalg.norm(sums, axis=-1, keepdims=True), 1e-30)
        self.vertex_average_normals = (sums / norms).astype(np.float32)

    # -- transforms & subdivision (mesh.cpp:361-395) ---------------------------
    def transform(self, matrix: np.ndarray, displacement: np.ndarray) -> None:
        m = np.asarray(matrix, np.float32)
        d = np.asarray(displacement, np.float32)
        self.tris = (self.tris @ m.T + d).astype(np.float32)

    def translate(self, displacement) -> "TriMesh":
        self.transform(np.eye(3, dtype=np.float32), displacement)
        return self

    def scale(self, factor) -> "TriMesh":
        if np.isscalar(factor):
            factor = np.eye(3, dtype=np.float32) * factor
        self.transform(factor, np.zeros(3, np.float32))
        return self

    # -- IO (mesh.cpp:399-430) ----------------------------------------------
    def read(self, path: str) -> "TriMesh":
        self.tris = stl_io.read_stl(path)
        self.fellow_triangles = None
        return self

    # -- device export -------------------------------------------------------
    def device_arrays(self) -> Dict[str, np.ndarray]:
        """Flat arrays consumed by the Bézier construction pass."""
        if self.fellow_triangles is None:
            raise ValueError("run standardize_normals() first")
        if self.corner_average_normals is not None:
            corner_avg_normals = self.corner_average_normals
        else:
            corner_avg_normals = self.vertex_average_normals[self.face2vertex]
        return dict(
            tris=self.tris,
            fellow_triangles=self.fellow_triangles.astype(np.int32),
            fellow_common_side_starts=self.fellow_common_side_starts.astype(np.int32),
            corner_average_normals=corner_avg_normals.astype(np.float32),
        )


# ---------------------------------------------------------------------------
# free helpers
# ---------------------------------------------------------------------------


def _proximity_intervals(sorted_vals: np.ndarray, eps: float) -> List[Tuple[int, int]]:
    """Group sorted projections into intervals where value - start < eps
    (mesh.cpp:24-54)."""
    intervals: List[Tuple[int, int]] = []
    start = 0
    start_val = sorted_vals[0]
    for i in range(1, len(sorted_vals)):
        if sorted_vals[i] - start_val >= eps:
            intervals.append((start, i))
            start, start_val = i, sorted_vals[i]
    intervals.append((start, len(sorted_vals)))
    return intervals


def _face_normals(tris: np.ndarray) -> np.ndarray:
    return np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])


def _altitude(c1: np.ndarray, c2: np.ndarray, indep: np.ndarray) -> np.ndarray:
    common = c2 - c1
    rel = indep - c1
    foot = float(common @ rel) / max(float(common @ common), 1e-30)
    return rel - common * foot


# ---------------------------------------------------------------------------
# procedural generators (mesh.cpp:434-477, mesh.h:98-100)
# ---------------------------------------------------------------------------

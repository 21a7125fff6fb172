"""The reference's own lens and rays, from the configuration's inputs.

`build_lens` repeats the port's `models/scenes.py::robot_lens_scene` recipe
(read, weld and orient, centre and scale to unit size, optionally one
thick-patch split pass, place at the lens centre, build) on the frozen NumPy
host stage and the frozen Clough-Tocher build, in float64.  `ortho_rays`
repeats the port's `OrthoGrid.rays_at` arithmetic in float32, op for op, so
that the reference traces the rays the program traces.
"""
from __future__ import annotations

import numpy as np
import torch

from .build import build_from_trimesh
from .mesh import TriMesh
from .refine import split_thick_patches
from .tracer import Lens


def _preprocess(mesh: TriMesh) -> TriMesh:
    """Weld, orient, neighbour tables, vertex-average normals (the port's
    `harness/measure.py::preprocess` on its NumPy path)."""
    mesh.standardize_vertices()
    mesh.standardize_normals()
    return mesh


def build_patches(stl_path: str, lens_center, refine: bool, device, dtype=torch.float64):
    """The frozen build's BezierPatches of the lens in `dtype` on `device`."""
    mesh = _preprocess(TriMesh().read(stl_path))
    center = mesh.tris.reshape(-1, 3).mean(axis=0)
    mesh.translate(-center)
    mesh.scale(1.0 / float(np.abs(mesh.tris).max()))
    mesh = _preprocess(mesh)
    if refine:
        patches = build_from_trimesh(mesh, device=device, dtype=dtype)
        tris, _ = split_thick_patches(patches, mesh.fellow_triangles,
                                      mesh.fellow_common_side_starts)
        mesh = _preprocess(TriMesh(tris))
    mesh.translate(np.asarray(lens_center, np.float32))
    mesh = _preprocess(mesh)
    return build_from_trimesh(mesh, device=device, dtype=dtype)


def build_lens(config: dict, stl_path: str, device) -> Lens:
    """The configuration's lens as the reference traces it (float64)."""
    p = build_patches(stl_path, config["lens_center"], bool(config["refine"]), device)
    return Lens(
        control_points=p.control_points, neighbours=p.neighbours.long(),
        underlying=p.underlying, dividers=p.dividers, bary_inverse=p.bary_inverse,
        heights=p.heights, deriv_b=p.deriv_b,
        refractive_index=torch.tensor(float(config["refractive_index"]), dtype=torch.float64,
                                      device=device),
    )


def _beam_frame(center, direction, up):
    center = np.asarray(center, np.float32)
    d = np.asarray(direction, np.float32)
    d = d / np.linalg.norm(d)
    up = np.asarray(up, np.float32)
    right = np.cross(d, up)
    right /= np.linalg.norm(right)
    return center, d, right, np.cross(right, d)


def ortho_rays(grid: dict, idx):
    """(start [N,3], direction [N,3]) float32 of the collimated beam `grid`
    (center, direction, up, width, res; the 16x8-block tile order where res
    admits it) at flat ray indices idx, as the port's `OrthoGrid.rays_at`."""
    dev = idx.device
    center, d, right, v_up = (torch.as_tensor(v, device=dev) for v in _beam_frame(
        grid["center"], grid["direction"], grid["up"]))

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    res = int(grid["res"])
    i = idx.to(torch.int64)
    if res % 16 == 0 and res % 8 == 0:
        nby = res // 8
        t, w = i // 128, i % 128
        ix, iy = (t // nby) * 16 + (w // 8), (t % nby) * 8 + (w % 8)
    else:
        ix, iy = i // res, i % res
    half = f32(0.5)
    width = f32(float(grid["width"]))
    gx = ((ix.to(torch.float32) + half) / f32(res) - half) * width
    gy = ((iy.to(torch.float32) + half) / f32(res) - half) * width
    start = center[None] + gx[:, None] * right[None]
    start = start + gy[:, None] * v_up[None]
    return start, d.expand(start.shape).contiguous()

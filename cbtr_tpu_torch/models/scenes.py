"""Standard scenes mirroring the reference's fixtures.

Counterpart of cbtr_tpu/models/scenes.py.  Each scene = a preprocessed
Bezier lens + a collimated ray grid + a screen plane, ready for
`render_lens_image`:

* sphere lens   <- makeUnitSphere fixture (reference/mesh.h:100)
* ellipsoid     <- makeEllipsoid 1,4,2 axes (reference/test.cpp:497)
* dimpled solid <- the intersection-test fixture (reference/test.cpp:241-245)
* robot.stl     <- the free-form mesh fixture (reference/test.cpp:473-494)

The robot mesh is read from the JAX package's data file by path (a data
file, not an import).
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..bezier import BezierPatches, build_from_trimesh, split_thick_patches
from ..harness.measure import preprocess
from ..mesh.core import (
    TriMesh,
    make_dimpled_solid,
    make_ellipsoid,
    make_unit_sphere,
)
from ..render.camera import ortho_ray_grid


def robot_stl_path() -> str:
    """Path of the robot.stl fixture (reference/test.cpp:473-494's free-form
    mesh), vendored at cbtr_tpu/data/robot.stl; the CBTR_ROBOT_STL
    environment variable overrides it."""
    override = os.environ.get("CBTR_ROBOT_STL", "")
    if override:
        return override
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(repo, "cbtr_tpu", "data", "robot.stl")


LENS_CENTER = np.array([5.0, 0.0, 0.0], np.float32)
SCREEN_X = 10.0
ROBOT_BEAM_WIDTH = 1.8      # collimated-beam edge for the robot fixture
SPHERE_BEAM_WIDTH = 1.6     # ... for the unit-sphere fixture
ELLIPSOID_BEAM_WIDTH = 3.0  # ... for the ellipsoid/dimpled fixtures


class LensScene(NamedTuple):
    patches: BezierPatches
    start: torch.Tensor         # [N,3]
    direction: torch.Tensor     # [N,3]
    screen_plane: torch.Tensor  # [4]
    refractive_index: float
    fellow: np.ndarray          # original neighbour tables (refinement input)
    fellow_starts: np.ndarray


def _finish(mesh: TriMesh, res: int, beam_width: float,
            refractive_index: float, device, dtype=torch.float32) -> LensScene:
    mesh.translate(LENS_CENTER)
    mesh = preprocess(mesh)
    patches = build_from_trimesh(mesh, device=device, dtype=dtype)
    start, direction = ortho_ray_grid(
        center=(0.0, 0.0, 0.0),
        direction=(1.0, 0.0, 0.0),
        up=(0.0, 0.0, 1.0),
        width=beam_width,
        height=beam_width,
        res_x=res,
        res_y=res,
    )
    # screen: plane x = SCREEN_X, normal -x so incoming rays see it
    screen = torch.tensor([1.0, 0.0, 0.0, SCREEN_X], dtype=torch.float32,
                          device=device)
    return LensScene(
        patches=patches,
        start=torch.as_tensor(start, device=device),
        direction=torch.as_tensor(direction, device=device),
        screen_plane=screen,
        refractive_index=refractive_index,
        fellow=mesh.fellow_triangles,
        fellow_starts=mesh.fellow_common_side_starts,
    )


def sphere_lens_scene(res: int = 128, sectors: int = 15, belts: int = 7,
                      refractive_index: float = 1.3, device="cuda") -> LensScene:
    return _finish(preprocess(make_unit_sphere(sectors, belts)), res,
                   SPHERE_BEAM_WIDTH, refractive_index, device)


def ellipsoid_lens_scene(res: int = 128, sectors: int = 15, belts: int = 5,
                         refractive_index: float = 1.3, device="cuda",
                         dtype=torch.float32) -> LensScene:
    mesh = preprocess(make_ellipsoid(sectors, belts, (1.0, 4.0, 2.0)))
    return _finish(mesh, res, ELLIPSOID_BEAM_WIDTH, refractive_index, device, dtype)


def dimpled_lens_scene(res: int = 128, sectors: int = 21, belts: int = 15,
                       refractive_index: float = 1.3, device="cuda",
                       dtype=torch.float32) -> LensScene:
    mesh = preprocess(make_dimpled_solid(sectors, belts, (1.0, 4.0, 2.0)))
    return _finish(mesh, res, ELLIPSOID_BEAM_WIDTH, refractive_index, device, dtype)


def robot_lens_scene(res: int = 128, refractive_index: float = 1.3,
                     path: Optional[str] = None, refine: bool = False,
                     split: int = 0, device="cuda",
                     dtype=torch.float32) -> LensScene:
    """The free-form robot.stl fixture as a lens (450 patches).  dtype is the
    patch tables' type (float64 gives a reference build).  Every scene is
    built on the card unless the caller passes device="cpu".

    refine=True runs one adaptive thick-patch split pass first (1800
    patches; the workflow reference/test.cpp:473-494 stops short of);
    split=k first divides every triangle k^2-fold (Mesh::splitTriangles,
    reference/mesh.cpp:389-395): split=4 gives 7200 patches, split=6
    16,200.  The refinement samples the f32 build on `device`, whatever
    `dtype` the final tables take."""
    path = path or robot_stl_path()
    mesh = TriMesh().read(path)
    mesh = preprocess(mesh)
    # normalize to unit-ish scale around origin before lens placement
    center = mesh.tris.reshape(-1, 3).mean(axis=0)
    mesh.translate(-center)
    scale = float(np.abs(mesh.tris).max())
    mesh.scale(1.0 / scale)
    mesh = preprocess(mesh)
    if split:
        mesh.split_triangles(split)
        mesh = preprocess(mesh)
    if refine:
        patches = build_from_trimesh(mesh, device=device)
        tris, _ = split_thick_patches(
            patches, mesh.fellow_triangles, mesh.fellow_common_side_starts
        )
        mesh = preprocess(TriMesh(tris))
    return _finish(mesh, res, ROBOT_BEAM_WIDTH, refractive_index, device, dtype)

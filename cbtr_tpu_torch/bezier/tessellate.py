"""Surface tessellation: BezierPatches -> dense triangle soup.

Counterpart of cbtr_tpu/bezier/tessellate.py, equivalent of
BezierMesh::interpolate (reference/bezierMesh.cpp:55-66): the unit
barycentric triangle is subdivided by `divisor` and every sub-corner is
pushed through each patch's cubic interpolation, as one batched evaluation
of shape [P, T, 3 corners].  Emission order is patch-major (the reference's
is sub-triangle-major); the triangle set is the same.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import geom
from .patches import BezierPatches, interpolate, interpolate_linear


def tessellate(patches: BezierPatches, divisor: int, blend: float = 1.0):
    """[P*divisor^2, 3, 3] triangle soup on the patches' device.

    blend < 1 mixes the cubic point with the linear (flat) point, as the
    thick-patch splitter does (reference/bezierMesh.cpp:200-204)."""
    cp = patches.control_points
    bary = torch.as_tensor(geom.subdivision_barycentrics(divisor),
                           dtype=cp.dtype, device=cp.device)        # [T,3,3]
    cp = cp[:, None, None, :, :]                                    # [P,1,1,10,3]
    pts = interpolate(cp, bary[None])                               # [P,T,3,3]
    if blend != 1.0:
        pts = pts * blend + interpolate_linear(cp, bary[None]) * (1.0 - blend)
    return pts.reshape(-1, 3, 3)


def tessellate_to_numpy(patches: BezierPatches, divisor: int) -> np.ndarray:
    return tessellate(patches, divisor).detach().cpu().numpy().astype(np.float32)

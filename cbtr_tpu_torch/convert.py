"""Arrays handed over as NumPy (e.g. from the JAX package, in the tests) ->
the port's tensors, so both packages compute on the same inputs.  Imports
no jax."""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .bezier.patches import BezierPatches
from .models.lens_model import LensParams


def patches_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> BezierPatches:
    """{leaf name: array} (the BezierPatches field names) -> BezierPatches."""
    return BezierPatches(**{
        f.name: torch.as_tensor(np.array(arrays[f.name]), device=device)
        for f in dataclasses.fields(BezierPatches)
    })


def params_from_numpy(control_points, refractive_index,
                      patches: BezierPatches) -> LensParams:
    """Lens parameters from NumPy values; `patches` supplies the built
    tables (its own control points are replaced)."""
    params = LensParams(patches, float(np.asarray(refractive_index)))
    with torch.no_grad():
        params.control_points.copy_(torch.tensor(np.asarray(control_points)))
    return params

"""Checkpoint / resume.

Counterpart of cbtr_tpu/utils/checkpoint.py, with the same `.npz` layout,
so that a file written by either package loads in the other:

* `save_patches`/`load_patches` -- the seven BezierPatches fields, in their
  declaration order, as one .npz (the host preprocessing and the Bezier
  build never have to rerun);
* `save_params`/`load_params` -- lens parameters as `control_points`,
  `refractive_index` and an int64 `__step__`, and nothing else: not the
  built tables the port's `LensParams` holds as buffers;
* `latest_checkpoint` -- the highest-step `ckpt_{step}.npz` of a directory,
  where a resumed fit starts.

Every write goes to a `.tmp` file first and is moved into place with
`os.replace`, so a crash never leaves a torn checkpoint.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..bezier.patches import BezierPatches

_PATCH_FIELDS = tuple(f.name for f in dataclasses.fields(BezierPatches))
_PARAM_FIELDS = ("control_points", "refractive_index")


def _save_npz(path: str, arrays: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)  # atomic: a crash never leaves a torn checkpoint


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_patches(path: str, patches: BezierPatches) -> None:
    _save_npz(path, {f: _host(getattr(patches, f)) for f in _PATCH_FIELDS})


def load_patches(path: str, device="cuda") -> BezierPatches:
    with np.load(path) as data:
        return BezierPatches(**{f: torch.as_tensor(data[f], device=device)
                                for f in _PATCH_FIELDS})


def save_params(path: str, params, step: int = 0) -> None:
    """Save a LensParams' control points and refractive index, and the
    step counter."""
    arrays = {f: _host(getattr(params, f)) for f in _PARAM_FIELDS}
    arrays["__step__"] = np.asarray(step, np.int64)
    _save_npz(path, arrays)


def load_params(path: str, patches: BezierPatches, device="cuda") -> Tuple[object, int]:
    """Load params saved by `save_params` (by either package); returns
    (LensParams, step).

    The file holds only the control points and the refractive index.  The
    module's tables (planes, heights, inverses, dividers, neighbours) are
    built from `patches` -- the scene's initial build -- and the stored
    control points are copied in: the JAX package's semantics, whose train
    step reads the tables of the scene's patches whatever the parameters
    (cbtr_tpu/models/fit.py and `make_train_step(scene.patches, ...)`)."""
    from ..models.lens_model import LensParams

    with np.load(path) as data:
        step = int(data["__step__"]) if "__step__" in data else 0
        cp = torch.as_tensor(data["control_points"], device=device)
        params = LensParams(patches.map(lambda t: t.to(device)),
                            float(data["refractive_index"]))
    with torch.no_grad():
        params.control_points.copy_(cp)
    return params, step


def latest_checkpoint(directory: str, prefix: str = "ckpt_") -> Optional[str]:
    """Highest-step checkpoint file `{prefix}{step}.npz` in a directory."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(".npz"):
            try:
                step = int(name[len(prefix):-4])
            except ValueError:
                continue
            if step > best_step:
                best, best_step = os.path.join(directory, name), step
    return best

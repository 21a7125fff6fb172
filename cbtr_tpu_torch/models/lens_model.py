"""The differentiable lens model: optimize a Bezier lens by gradient descent.

Counterpart of cbtr_tpu/models/lens_model.py.  Pixels of the rendered
irradiance image are differentiable w.r.t. the lens control points and the
refractive index, so a target illumination pattern can be fit.

The lens is an `nn.Module`: `control_points` and `refractive_index` are
Parameters; everything else in the BezierPatches tables (planes, heights,
inverse matrices, dividers, neighbours) is a buffer holding the values built
from the initial control net.  The tables are NOT rebuilt as the control
points move — the JAX package's semantics, consistent for small steps;
rebuild with `bezier.build_patches` for large ones.  Because the module holds
the tables, the JAX functions' separate `patches` argument is absorbed into
`params` here.
"""
from __future__ import annotations

import torch
from torch import nn

from ..bezier.patches import BezierPatches
from ..render.render import render_lens_image

_TABLES = ("neighbours", "underlying", "dividers", "bary_inverse", "heights",
           "deriv_b")


class LensParams(nn.Module):
    """Lens parameters (control_points [P,10,3], refractive_index scalar) and
    the built tables they index into (buffers)."""

    def __init__(self, patches: BezierPatches, refractive_index):
        super().__init__()
        cp = patches.control_points.detach()
        self.control_points = nn.Parameter(cp.to(torch.float32).clone())
        self.refractive_index = nn.Parameter(torch.as_tensor(
            refractive_index, dtype=torch.float32, device=cp.device).detach().clone())
        for name in _TABLES:
            self.register_buffer(name, getattr(patches, name).detach().clone())

    def patches(self) -> BezierPatches:
        return BezierPatches(control_points=self.control_points,
                             **{name: getattr(self, name) for name in _TABLES})

    def forward(self, start, direction, screen_plane, resolution: int = 128,
                extent: float = 4.0, chunk_size: int = 0, ray_weights=None,
                backend: str = "auto"):
        return render_lens_image(
            self.patches(), self.refractive_index, start, direction,
            screen_plane, extent=extent, resolution=resolution,
            chunk_size=chunk_size, weights=ray_weights, backend=backend,
        )


def params_from_scene(scene) -> LensParams:
    return LensParams(scene.patches, scene.refractive_index)


def lens_forward(params: LensParams, start, direction, screen_plane,
                 resolution: int = 128, extent: float = 4.0,
                 chunk_size: int = 0, ray_weights=None, backend: str = "auto"):
    """Irradiance image for the current lens parameters.

    ray_weights: optional per-ray multiplier; 0 removes a ray."""
    return params(start, direction, screen_plane, resolution=resolution,
                  extent=extent, chunk_size=chunk_size,
                  ray_weights=ray_weights, backend=backend)


def lens_loss(params: LensParams, start, direction, screen_plane, target,
              resolution: int = 128, extent: float = 4.0, chunk_size: int = 0,
              ray_weights=None, backend: str = "auto"):
    img = lens_forward(
        params, start, direction, screen_plane, resolution=resolution,
        extent=extent, chunk_size=chunk_size, ray_weights=ray_weights,
        backend=backend,
    )
    return torch.mean((img - target) ** 2)


def make_train_step(screen_plane, target, resolution: int = 128,
                    extent: float = 4.0, learning_rate: float = 1e-3,
                    chunk_size: int = 0, backend: str = "auto"):
    """SGD step: (params, start, direction) -> (params, loss).

    Updates the parameters in place (p <- p - lr * grad) and returns the
    same module with the detached loss."""

    def step(params: LensParams, start, direction):
        params.zero_grad(set_to_none=True)
        loss = lens_loss(params, start, direction, screen_plane, target,
                         resolution=resolution, extent=extent,
                         chunk_size=chunk_size, backend=backend)
        loss.backward()
        with torch.no_grad():
            for p in (params.control_points, params.refractive_index):
                p -= learning_rate * p.grad
        return params, loss.detach()

    return step

"""Preemption-safe lens optimization, and the emitter ray sets it fits with.

Counterpart of cbtr_tpu/models/fit.py.  `fit_lens` runs SGD (or a
`torch.optim` optimizer) on the differentiable render and checkpoints
atomically every `checkpoint_every` steps; a re-invocation with the same
`checkpoint_dir` resumes from the highest-step checkpoint.  The checkpoint
files are the JAX package's (`utils/checkpoint.py`), so a fit started by
one package resumes in the other.  A killed and resumed SGD fit ends on
the same parameters as an uninterrupted one bit for bit, on the CPU and on
the card in torch's default mode: the gradient is reproducible, since the
recompute's gather adds its backward with the fixed-order segment sum
(`ops/cuda_segment.py`) and not with atomics (tests/test_torch_fit.py,
chip_smoke.py phase j).
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from ..render.emitters import UniformHemisphere
from ..utils.checkpoint import latest_checkpoint, load_params, save_params
from .lens_model import LensParams, make_opt_train_step, make_train_step


def fit_lens(scene, target, steps: int, checkpoint_dir: Optional[str] = None,
             checkpoint_every: int = 10, learning_rate: float = 1e-3,
             resolution: int = 0,
             on_step: Optional[Callable[[int, float], None]] = None,
             rays=None, init_params: Optional[LensParams] = None,
             optimizer=None, device="cuda"):
    """Fit the lens control points + refractive index to `target`.

    Returns (params, losses list starting at the resumed step).  With
    `checkpoint_dir`, resumes from the latest `ckpt_{step}.npz` and writes a
    new checkpoint every `checkpoint_every` steps plus one at the end.
    rays: optional (start [N,3], direction [N,3]) overriding the scene's
    collimated grid (e.g. a point-source emitter set -- fit_emitter_lens);
    init_params: optional starting parameters (default: the scene's); only
    its control points and refractive index are read, the tables are the
    scene's (as in the JAX package, whose step closes over scene.patches),
    and the caller's module is not modified.
    optimizer: None for plain SGD at `learning_rate` through
    `make_train_step` (the resume-exact path), "adam" for
    `torch.optim.Adam(lr=learning_rate)` (optax.adam's defaults), or a
    callable taking the parameter list and returning a
    `torch.optim.Optimizer`.  Optimizer state is NOT checkpointed: a resumed
    adam run restarts its moments (the params themselves resume exactly).
    device: where the fit runs ("cuda" unless the caller says otherwise);
    the scene, the rays, the target and the start are moved there.
    A non-finite loss raises FloatingPointError.
    """
    patches = scene.patches.map(lambda t: t.to(device))
    screen = scene.screen_plane.to(device)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    resolution = resolution or int(target.shape[0])
    ray_s, ray_d = rays if rays is not None else (scene.start, scene.direction)
    ray_s, ray_d = ray_s.to(device), ray_d.to(device)

    if init_params is None:
        params = LensParams(patches, scene.refractive_index)
    else:
        params = LensParams(patches, init_params.refractive_index)
        with torch.no_grad():
            params.control_points.copy_(init_params.control_points)
    start_step = 0
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        ckpt = latest_checkpoint(checkpoint_dir)
        if ckpt is not None:
            params, start_step = load_params(ckpt, patches, device)

    if optimizer is None:
        step_fn = make_train_step(screen, target, resolution=resolution,
                                  learning_rate=learning_rate)
    else:
        parameters = [params.control_points, params.refractive_index]
        opt = (torch.optim.Adam(parameters, lr=learning_rate)
               if optimizer == "adam" else optimizer(parameters))
        opt_step = make_opt_train_step(screen, target, resolution=resolution)

        def step_fn(params, start, direction):
            params, _, loss = opt_step(params, opt, start, direction)
            return params, loss

    losses = []
    for step in range(start_step, steps):
        params, loss = step_fn(params, ray_s, ray_d)
        loss = float(loss)
        if not np.isfinite(loss):
            raise FloatingPointError(f"non-finite loss at step {step}")
        losses.append(loss)
        if on_step:
            on_step(step, loss)
        done = step + 1
        if checkpoint_dir and (done % checkpoint_every == 0 or done == steps):
            save_params(os.path.join(checkpoint_dir, f"ckpt_{done}.npz"), params, done)
    return params, losses


def emitter_rays(n_rays: int, belts: int = 16, seed: int = 0,
                 origin=(0.0, 0.0, 0.0), device="cuda"):
    """Point-source hemisphere ray set, sorted by the reference's belt/patch
    bin (reference/hostUtil.cpp:9-13) so the sweep kernels' cull sees
    coherent 128-ray tiles.  Returns (start [n,3], direction [n,3]) f32
    tensors on `device` (the card unless the caller passes "cpu"),
    bit-identical to the JAX package's arrays."""
    d, patch = UniformHemisphere(belts=belts, seed=seed).sample(n_rays)
    order = np.argsort(patch, kind="stable")
    direction = torch.as_tensor(d[order], device=device)
    start = torch.as_tensor(origin, dtype=torch.float32, device=device)
    return start.expand(direction.shape).contiguous(), direction


def fit_emitter_lens(scene, target, steps: int, n_rays: int = 4096,
                     belts: int = 16, seed: int = 0,
                     origin=(0.0, 0.0, 0.0), device="cuda", **kw):
    """Fit the lens to a target illumination pattern from a point source --
    the reference's motivating use case (car-lamp optics,
    reference/README.md:159-165): hemisphere-emitter rays
    (reference/hostUtil.cpp:16-29) refract through the lens and their screen
    splat is optimized toward `target`.

    The emitter set is sampled once (deterministic seed), bin-sorted, and
    held fixed across steps so the loss surface is stationary.  All fit_lens
    keyword arguments (checkpointing, learning_rate, init_params, ...) pass
    through."""
    return fit_lens(
        scene, target, steps,
        rays=emitter_rays(n_rays, belts=belts, seed=seed, origin=origin, device=device),
        device=device, **kw,
    )

"""Emitter ray sets for lens fitting.

Counterpart of `emitter_rays` in cbtr_tpu/models/fit.py; `fit_lens`,
`fit_emitter_lens` and the checkpointing they use are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..render.emitters import UniformHemisphere


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

"""Uniform hemisphere emitter sampling (reference hostUtil.{h,cpp}).

Counterpart of the host-side part of cbtr_tpu/render/emitters.py:
`belt_patch_counts` and `UniformHemisphere`, NumPy on the host as there,
so the same seed gives bit-identical directions and bins.  Incidence =
acos(U(0,1)) (uniform over the hemisphere's area without rejection,
reference/hostUtil.cpp:19), turn = U(0, 2pi), plus the belt/patch binning
the reference designed for GPU warp coherence (reference/hostUtil.cpp:9-13,
README.md:169-192); the port sorts rays by that bin so the sweep kernels'
128-ray tiles stay coherent (`models/fit.py::emitter_rays`).

`DeviceEmitter` and `sample_hemisphere` (jax.random's threefry) are not
ported yet.
"""
from __future__ import annotations

import numpy as np

from ..config import PI


def belt_patch_counts(belts: int) -> np.ndarray:
    """Patches per belt: ceil(4b * sin((2i+1)/(4b) * pi))
    (reference/hostUtil.cpp:11)."""
    i = np.arange(belts, dtype=np.float64)
    return np.ceil(4.0 * belts * np.sin((2.0 * i + 1.0) / (4.0 * belts) * PI)).astype(
        np.int64
    )


class UniformHemisphere:
    """Host-side emitter with patch binning (reference/hostUtil.{h,cpp})."""

    def __init__(self, belts: int, seed: int = 0):
        self.belts = int(belts)
        self.belt_width = PI / 2.0 / belts
        counts = belt_patch_counts(belts)
        self.patch_starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        self.patch_widths = 2.0 * PI / counts
        self.patch_count = int(counts.sum())
        self._rng = np.random.default_rng(seed)

    def sample(self, n: int):
        """-> (directions [n,3] f32 around +x, patch indices [n] i32), NumPy."""
        incidence = np.arccos(self._rng.uniform(0.0, 1.0, n))
        turn = self._rng.uniform(0.0, 2.0 * PI, n)
        belt_radius = np.sin(incidence)
        d = np.stack(
            [np.cos(incidence), belt_radius * np.cos(turn), belt_radius * np.sin(turn)],
            axis=-1,
        )
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        belt = np.minimum((incidence / self.belt_width).astype(np.int64), self.belts - 1)
        patch = self.patch_starts[belt] + (turn / self.patch_widths[belt]).astype(
            np.int64
        )
        return d.astype(np.float32), patch.astype(np.int32)

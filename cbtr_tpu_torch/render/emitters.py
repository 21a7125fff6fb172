"""Uniform hemisphere emitter sampling (reference hostUtil.{h,cpp}).

Counterpart of cbtr_tpu/render/emitters.py.  Three implementations:

* `UniformHemisphere` -- NumPy on the host as in the JAX package, so the
  same seed gives bit-identical directions and bins.  Incidence =
  acos(U(0,1)) (uniform over the hemisphere's area without rejection,
  reference/hostUtil.cpp:19), turn = U(0, 2pi), plus the belt/patch binning
  the reference designed for GPU warp coherence (reference/hostUtil.cpp:9-13,
  README.md:169-192); the port sorts rays by that bin so the sweep kernels'
  128-ray tiles stay coherent (`models/fit.py::emitter_rays`).

* `DeviceEmitter` -- rays synthesized on the device, already ordered by that
  same bin: no host sampling, no host argsort, no upload.  `synthesize` is
  that synthesis, the port's ray synthesis layer (span `cbtr.emitter`).

* `sample_hemisphere` -- directions from a threefry key, on the key's device.

The last two draw through `utils.prng`, threefry-2x32 in torch integer ops,
so their uniform draws are bit-equal to the JAX package's jax.random ones;
the float tail (cos, sin, sqrt) differs by ulps between XLA, torch's CPU
code and CUDA.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import PI
from ..utils import prng
from ..utils.profiling import span


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


class DeviceEmitter(NamedTuple):
    """Point-source hemisphere emitter with rays synthesized on the device,
    already ordered by the reference's belt/patch bin.

    Ray index space is partitioned over the bins in bin order, each bin
    getting a contiguous index range of round(n * bin_area_fraction) rays,
    so synthesized rays are sorted by construction (no sort) and a sharded
    render's contiguous per-device index slices keep tile coherence.  Within
    a bin, incidence is stratified along the cos axis ((j + u)/count over
    the bin's cos range: uniform over the sphere's area, like the
    reference's acos(U) draw restricted to the belt) and the turn is uniform
    over the bin's angular width.  The jitter u is threefry's
    `uniform(fold_in(PRNGKey(seed), i), 2)`, so a ray is a function of
    (seed, global index) alone and any sharding synthesizes the same rays.
    Bin rounding is unbiased by per-ray weights
    w = n * bin_fraction / bin_count (sum(w) = n; the splat takes per-ray
    weights).  All fields are hashable, like OrthoGrid's."""

    origin: tuple      # (3,) emitter position
    belts: int
    n_rays: int
    seed: int = 0

    def _tables(self):
        """Static per-patch tables (NumPy, the JAX package's values)."""
        B = self.belts
        counts = belt_patch_counts(B)                       # [B]
        w = PI / 2.0 / B
        cos_a = np.cos(np.arange(B) * w)                    # belt near edge
        cos_b = np.cos((np.arange(B) + 1) * w)              # belt far edge
        belt_of = np.repeat(np.arange(B), counts)           # [Np]
        pin = np.concatenate([np.arange(c) for c in counts])  # patch-in-belt
        frac = (cos_a - cos_b)[belt_of] / counts[belt_of]   # area fractions
        bounds = np.round(np.cumsum(frac) * self.n_rays).astype(np.int64)
        bounds[-1] = self.n_rays                            # fp-exact total
        starts = np.concatenate([[0], bounds[:-1]])
        nb = bounds - starts                                # rays per patch
        return {
            "bounds": bounds,
            "starts": starts,
            "nb": nb,
            "cos_a": cos_a[belt_of].astype(np.float32),
            "cos_b": cos_b[belt_of].astype(np.float32),
            "turn0": (pin * (2.0 * PI / counts[belt_of])).astype(np.float32),
            "turn_w": (2.0 * PI / counts[belt_of]).astype(np.float32),
            "frac": frac.astype(np.float32),
        }

    def draws(self, idx):
        """The jitter u [N,2] f32 of global indices idx [N]:
        uniform(fold_in(PRNGKey(seed), i), 2) for each, on idx's device."""
        key = prng.prng_key(self.seed, idx.device)
        return prng.uniform(prng.fold_in(key, idx.to(torch.int64)), 2)

    def bins_at(self, idx, tables=None, u=None):
        """The integer and random part of `rays_at`: (u [N,2] f32 jitter,
        patch [N] i64 bin, j [N] f32 index inside the bin, cnt [N] f32 rays
        in the bin) for global indices idx [N], on idx's device.  u: the
        draws (`draws`), where the caller made them already."""
        t = tables or self._device_tables(idx.device)
        idx = idx.to(torch.int64)
        u = self.draws(idx) if u is None else u
        patch = torch.searchsorted(t["bounds"], idx, right=True)
        patch = patch.clamp(max=t["bounds"].shape[0] - 1)
        cnt = t["nb"][patch].clamp(min=1).to(torch.float32)
        j = (idx - t["starts"][patch]).to(torch.float32)
        return u, patch, j, cnt

    def _device_tables(self, device):
        return {k: torch.as_tensor(v, device=device) for k, v in self._tables().items()}

    def rays_at(self, idx):
        """(start [N,3], direction [N,3], weight [N]) f32 for global ray
        indices idx [N] (an integer tensor), on idx's device --
        deterministic in (seed, idx), so callers synthesizing disjoint
        slices reproduce the whole set's rays (`synthesize`)."""
        return synthesize(self, idx)


@span("cbtr.emitter", device=True)
def synthesize(emitter: DeviceEmitter, idx):
    """The emitter's rays at global ray indices idx [N] (an integer tensor):
    (start [N,3], direction [N,3], weight [N]) f32 on idx's device.  The
    port's ray synthesis layer: the renders and the train step call it
    through this module's attribute, and under `profiling.timing()` it
    times its device work (`cbtr.emitter.device`).  The draws are queued
    first, so that the bin tables' host build overlaps their hash on the
    card (the tables' uploads then wait for it); after that nothing waits
    for the card: the start is filled there, not copied from the host."""
    u = emitter.draws(idx)
    t = emitter._device_tables(idx.device)
    _, patch, j, cnt = emitter.bins_at(idx, t, u)
    cos_a, cos_b = t["cos_a"][patch], t["cos_b"][patch]
    # stratified cos(incidence) over the belt's [cos_b, cos_a] range
    u1 = (j + u[:, 0]) / cnt
    cosv = cos_a - u1 * (cos_a - cos_b)
    sinv = torch.sqrt(torch.clamp(1.0 - cosv * cosv, min=0.0))
    turn = t["turn0"][patch] + u[:, 1] * t["turn_w"][patch]
    d = torch.stack([cosv, sinv * torch.cos(turn), sinv * torch.sin(turn)], dim=-1)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    start = torch.empty_like(d)
    for k, o in enumerate(emitter.origin):
        start[:, k] = o
    weight = t["frac"][patch] * float(emitter.n_rays) / cnt
    return start, d, weight


def sample_hemisphere(key, n: int):
    """Uniform hemisphere directions around +x, [n,3] f32, from a threefry
    key (`utils.prng.prng_key`) on the key's device: the JAX package's
    jax.random version with the same draws."""
    k1, k2 = prng.split(key)
    incidence = torch.arccos(prng.uniform(k1, n))
    turn = prng.uniform(k2, n, 0.0, 2.0 * PI)
    r = torch.sin(incidence)
    d = torch.stack([torch.cos(incidence), r * torch.cos(turn), r * torch.sin(turn)],
                    dim=-1)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)

"""The reference's point source: its rays and its weighted render.

The emitter is the car-lamp case of the reference project (a point light
behind a free-form lens, reference README.md:159-198) with the belt-and-patch
binning of reference hostUtil.cpp:9-13, as the port's `DeviceEmitter`
docstring states the rule:

* belt i of b (i = 0 .. b-1) spans incidence [i, i+1] x pi / (2b) and holds
  ceil(4b sin((2i+1) pi / (4b))) patches (bins) of equal turn;
* a bin's share of the rays is its share of the hemisphere's area, (cos of
  the belt's near edge - cos of its far edge) / the belt's patches; the bins
  take contiguous ranges of the ray index in bin order, their bounds the
  rounded running sums of the shares times the rays, the last bound the rays;
* ray j of a bin of c rays takes cos(incidence) at (j + u0) / c of the way
  from the belt's near edge's cos to its far edge's (stratified over the
  area), and its turn at u1 of the way across the bin; it carries the weight
  share x rays / c, so the weights sum to the rays;
* (u0, u1) = jax.random.uniform(jax.random.fold_in(PRNGKey(seed), index), (2,)).

The random bits are Threefry-2x32 with 20 rounds (Salmon, Moraes, Dror and
Shaw, "Parallel random numbers: as easy as 1, 2, 3", SC 2011; the Random123
constants) under jax.random's definitions in its partitionable mode (the
default since jax 0.5): PRNGKey(s) = (0, s mod 2^32) under jax's 32-bit
types; fold_in(k, x) = the hash of the counter pair (0, x) under k;
uniform(k, (n,)) hashes the counters (0, i), takes the xor of the two words,
puts its top 23 bits under the exponent of 1.0f and subtracts 1.  Each
word is an int64 holding a uint32, masked after every add and shift.

The rays are made in float32, as the program makes them; the render is the
reference's `tracer` in float64 with each ray's weight in the splat.
"""
from __future__ import annotations

import math

import torch

from . import tracer

MASK = 0xFFFFFFFF
ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)   # Threefry-2x32, rounds 0-7, then again
PARITY = 0x1BD11BDA                            # the key schedule's third word's constant
ONE_F32_BITS = 0x3F800000


def _rotate_left(x, bits: int):
    return ((x << bits) & MASK) | (x >> (32 - bits))


def threefry2x32(key, x0, x1):
    """Threefry-2x32, 20 rounds, of the counter words (x0, x1) under the key
    words key = (k0, k1); int64 tensors holding uint32 values, broadcast."""
    k0, k1 = key
    schedule = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + schedule[0]) & MASK
    x1 = (x1 + schedule[1]) & MASK
    for r in range(20):
        x0 = (x0 + x1) & MASK
        x1 = _rotate_left(x1, ROTATIONS[r % 8]) ^ x0
        if r % 4 == 3:                  # key injection s after every 4 rounds
            s = r // 4 + 1
            x0 = (x0 + schedule[s % 3]) & MASK
            x1 = (x1 + schedule[(s + 1) % 3] + s) & MASK
    return x0, x1


def prng_key(seed: int, device):
    """jax.random.PRNGKey(seed) with 32-bit types: the words (0, seed mod 2^32)."""
    return (torch.zeros((), dtype=torch.int64, device=device),
            torch.tensor(int(seed) % (1 << 32), dtype=torch.int64, device=device))


def fold_in(key, data):
    """jax.random.fold_in(key, data) for each element of the integer tensor
    data: the key words of each, shaped as data."""
    data = data.to(torch.int64) & MASK
    return threefry2x32(key, torch.zeros_like(data), data)


def uniform(key, n: int):
    """jax.random.uniform(key, (n,)) in [0, 1), float32, for key words of
    any shape S: [*S, n]."""
    k0, k1 = (k[..., None] for k in key)
    counter = torch.arange(n, dtype=torch.int64, device=k0.device)
    y0, y1 = threefry2x32((k0, k1), torch.zeros_like(counter), counter)
    bits = y0 ^ y1
    floats = ((bits >> 9) | ONE_F32_BITS).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(0.0, dtype=torch.float32, device=k0.device)
    hi = torch.tensor(1.0, dtype=torch.float32, device=k0.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def bins(belts: int, n_rays: int, device) -> dict:
    """The per-bin tables, in bin order (belt by belt, turn by turn): the
    bin's first ray and ray count (int64), its belt's cos edges, its turn's
    start and width and its area share (float64 arithmetic, float32 kept)."""
    b = int(belts)
    i = torch.arange(b, dtype=torch.float64)
    per_belt = torch.ceil(4.0 * b * torch.sin((2.0 * i + 1.0) / (4.0 * b) * math.pi)).long()
    belt = torch.repeat_interleave(torch.arange(b), per_belt)
    in_belt = torch.cat([torch.arange(int(c)) for c in per_belt])
    edge = math.pi / 2.0 / b
    cos_near = torch.cos(torch.arange(b, dtype=torch.float64) * edge)
    cos_far = torch.cos((torch.arange(b, dtype=torch.float64) + 1.0) * edge)
    count = per_belt[belt].double()
    share = (cos_near - cos_far)[belt] / count
    bound = torch.round(torch.cumsum(share, 0) * n_rays).long()
    bound[-1] = n_rays
    first = torch.cat([bound.new_zeros(1), bound[:-1]])
    width = 2.0 * math.pi / count
    f32 = {"cos_near": cos_near[belt], "cos_far": cos_far[belt], "turn0": in_belt * width,
           "turn_width": width, "share": share}
    out = {k: v.to(device, torch.float32) for k, v in f32.items()}
    out.update(bound=bound.to(device), first=first.to(device), rays=(bound - first).to(device))
    return out


def rays(spec: dict, idx):
    """(start [N,3], direction [N,3], weight [N]) float32 of the emitter
    spec = {origin, belts, n_rays, seed} at the global ray indices idx [N],
    on idx's device."""
    dev = idx.device
    n = int(spec["n_rays"])
    t = bins(spec["belts"], n, dev)
    i = idx.to(torch.int64)
    u = uniform(fold_in(prng_key(spec["seed"], dev), i), 2)
    b = torch.searchsorted(t["bound"], i, right=True).clamp(max=t["bound"].shape[0] - 1)
    count = t["rays"][b].clamp(min=1).to(torch.float32)
    j = (i - t["first"][b]).to(torch.float32)
    near, far = t["cos_near"][b], t["cos_far"][b]
    cos_inc = near - (j + u[:, 0]) / count * (near - far)
    sin_inc = torch.sqrt(torch.clamp(1.0 - cos_inc * cos_inc, min=0.0))
    turn = t["turn0"][b] + u[:, 1] * t["turn_width"][b]
    d = torch.stack([cos_inc, sin_inc * torch.cos(turn), sin_inc * torch.sin(turn)], dim=-1)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    start = torch.tensor(spec["origin"], dtype=torch.float32, device=dev).expand(d.shape)
    weight = t["share"][b] * float(n) / count
    return start.contiguous(), d, weight


def render(lens, start, direction, weight, screen_plane, extent: float, res: int,
           chunk: int = 1 << 20):
    """The weighted render of the rays, float64, without gradients, in
    chunks: entry and exit refraction (`tracer.refract`), the screen
    (`tracer.screen_hits`), each live ray's weight splatted
    (`tracer.splat`).  Returns the image and a `tracer.Trace` of every ray's
    passes."""
    image, parts = None, []
    with torch.no_grad():
        for r0 in range(0, start.shape[0], chunk):
            s = start[r0:r0 + chunk].double()
            d = direction[r0:r0 + chunk].double()
            w = weight[r0:r0 + chunk].double()
            s1, d1, st1, h1 = tracer.refract(lens, s, d, tracer.R_INSIDE)
            s2, d2, st2, h2 = tracer.refract(lens, s1, d1, tracer.R_OUTSIDE)
            hit2d, on_screen = tracer.screen_hits(s2, d2, screen_plane)
            live = (st1 == tracer.R_INSIDE) & (st2 == tracer.R_OUTSIDE) & on_screen
            hit2d = torch.where(live[:, None], hit2d, 0.0)
            part = tracer.splat(hit2d, torch.where(live, w, 0.0), extent, res)
            image = part if image is None else image + part
            parts.append((h1.patch, h1.distance, s1, d1, st1, h2.patch, h2.distance, s2, d2,
                          st2))
    fields = [torch.cat(f) for f in zip(*parts)]
    return image, tracer.Trace(*fields, image)

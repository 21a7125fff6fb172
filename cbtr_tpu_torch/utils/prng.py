"""Threefry-2x32 counter-based random numbers in torch integer ops.

Counterpart of the parts of jax.random that the JAX package's emitters call
(jax 0.9.0, `jax/_src/prng.py` and `jax/_src/random.py`, with the default
`jax_threefry_partitionable = True`): `prng_key`, `fold_in`, `split`,
`random_bits` and `uniform` give the same bits as `jax.random.PRNGKey`,
`fold_in`, `split` and `uniform` on every device.  A key is a [..., 2]
int64 tensor holding two uint32 words; every word lives in an int64 masked
to 32 bits, since torch has no unsigned 32-bit arithmetic.  Rotations are
shifts and an or; all values stay below 2**62, so nothing overflows.

Each function is elementwise over leading key dimensions, so `fold_in` of
one key with a vector of indices gives one key per index (what `jax.vmap`
of `jax.random.fold_in` gives).
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA              # Threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the word pairs (x1, x2) under
    the key (k1, k2); all int64 tensors of uint32 values, broadcast
    together.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def prng_key(seed: int, device="cuda"):
    """`jax.random.PRNGKey(seed)` under jax's default 32-bit types: the
    words (0, seed modulo 2**32), as a [2] int64 tensor."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64, device=device)


def fold_in(key, data):
    """`jax.random.fold_in(key, data)`: the hash of the counter pair
    (0, data) under `key`.  key [..., 2]; data an int or an integer tensor
    (taken modulo 2**32, as jax casts it to uint32); the result broadcasts
    the two, [..., 2]."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def _counters(key, n: int):
    """(high, low) words of the counters 0..n-1, shaped to broadcast after
    the key's leading dimensions: `iota_2x32_shape((n,))`."""
    low = torch.arange(n, dtype=torch.int64, device=key.device)
    return torch.zeros_like(low), low


def split(key, num: int = 2):
    """`jax.random.split(key, num)` in the partitionable mode: key i is the
    hash of the counter pair (0, i).  key [2] -> [num, 2]; key [..., 2] ->
    [..., num, 2]."""
    hi, lo = _counters(key, num)
    y1, y2 = threefry2x32(key[..., 0, None], key[..., 1, None], hi, lo)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key, n: int):
    """32 random bits for each of n counters (`jax.random.bits(key, (n,))`
    in the partitionable mode: the xor of the hash's two words).  key
    [..., 2] -> [..., n] int64 in [0, 2**32)."""
    hi, lo = _counters(key, n)
    y1, y2 = threefry2x32(key[..., 0, None], key[..., 1, None], hi, lo)
    return y1 ^ y2


def uniform(key, n: int, minval: float = 0.0, maxval: float = 1.0):
    """`jax.random.uniform(key, (n,), minval=, maxval=)`, float32: the top 23
    bits become the mantissa of a float in [1, 2), less 1, then scaled,
    shifted and clamped below at minval, one f32 operation at a time as
    jax does.  key [..., 2] -> [..., n]."""
    bits = random_bits(key, n)
    one = 0x3F800000                     # the bits of 1.0f
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    # filled on the key's device: a copy from the host would wait for the
    # hash queued above to finish
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)

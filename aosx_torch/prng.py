"""The subset of ``jax.random`` that ``orchards.make_orchard`` draws from,
bit for bit: the threefry2x32 hash, ``PRNGKey``, ``split``, 32-bit random
bits and f32 ``uniform`` under JAX's partitionable threefry scheme (the
default, ``jax_threefry_partitionable=True``), and the erfinv of a uniform
that ``jax.random.normal`` scales.

A key is an int64 tensor [2] (or [..., 2]) holding two u32 words; ``split``,
``bits``, ``uniform`` and ``erfinv_uniform`` take leading key axes, each
key drawing its own stream (``jax.vmap`` over keys). The u32
arithmetic runs in int64 masked to 32 bits, since torch's uint32 lacks
operators on CUDA.

``jax.random.normal`` is sqrt(2) * erfinv(u) for a ``uniform`` u on
(-1, 1). ``erfinv_uniform`` gives erfinv(u), with XLA:CPU's f32 erfinv
reproduced bit for bit (``f32math``); ``make_orchard`` folds the sqrt(2)
into its jitter as XLA:CPU does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .f32math import erfinv_f32
from .ops import fma

M32 = 0xFFFFFFFF
SQRT2 = np.float32(math.sqrt(2.0))
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the count pairs (x1, x2) under
    the key (k1, k2); every argument holds u32 values in int64 tensors that
    broadcast together. Returns the two u32 output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & M32
    b = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & M32
    return a, b


def prng_key(seed: int, device) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: the words (0, seed)."""
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return torch.tensor([0, seed & M32], dtype=torch.int64, device=device)


def _counts(n: int, device):
    """The flat u64 iota of n counts as (high, low) u32 words (n < 2^32)."""
    lo = torch.arange(n, dtype=torch.int64, device=device)
    return torch.zeros_like(lo), lo


def split(key, num: int = 2):
    """``jax.random.split``: num keys, int64 [..., num, 2] for keys [..., 2]."""
    hi, lo = _counts(num, key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def bits(key, shape):
    """32 random bits for each element of ``shape`` (u32 values in int64),
    [..., *shape] for keys [..., 2]."""
    shape = tuple(shape)
    hi, lo = _counts(math.prod(shape), key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None], hi, lo)
    return (b1 ^ b2).reshape(key.shape[:-1] + shape)


def uniform(key, shape, minval=0.0, maxval=1.0):
    """``jax.random.uniform`` in f32: 23 random mantissa bits make f in
    [0, 1); the result is max(minval, f * (maxval - minval) + minval),
    rounded once, as XLA:CPU fuses the multiply-add. minval and maxval may
    be scalars or arrays broadcasting against ``shape``."""
    dev = key.device
    mantissa = (bits(key, shape) >> 9) | 0x3F800000
    f = mantissa.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.as_tensor(np.asarray(minval, np.float32), device=dev)
    hi = torch.as_tensor(np.asarray(maxval, np.float32), device=dev)
    return torch.maximum(lo, fma(f, (hi - lo).expand_as(f), lo.expand_as(f)))


def erfinv_uniform(key, shape):
    """erfinv(u) for ``jax.random.normal``'s uniform u on (nextafter(-1, 0), 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return erfinv_f32(uniform(key, shape, lo, 1.0))

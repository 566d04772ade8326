"""The population's keys and the random streams an orchard is drawn from,
written from the published algorithms: the Threefry-2x32 block cipher of
Salmon et al., "Parallel random numbers: as easy as 1, 2, 3" (SC 2011), 20
rounds, and JAX's partitionable key scheme (``jax.random.split`` hashes the
counts 0..n-1 under the key; 32 random bits are the xor of the two output
words; a uniform f32 takes 23 of them as its mantissa; a normal is
sqrt(2) erfinv of a uniform on (-1, 1)).

NumPy on the host, u32 arithmetic in uint64 masked to 32 bits. A key is a
pair of u32 words in an int64 array [..., 2]."""

from __future__ import annotations

import numpy as np

M32 = np.uint64(0xFFFFFFFF)
PARITY = np.uint64(0x1BD11BDA)
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d: int):
    return ((x << np.uint64(d)) | (x >> np.uint64(32 - d))) & M32


def threefry2x32(key, x0, x1):
    """The two output words of Threefry-2x32 (20 rounds) for the counter
    words (x0, x1) under key (k0, k1); arrays broadcast together."""
    k0, k1 = (np.asarray(k, np.uint64) for k in key)
    sched = (k0, k1, k0 ^ k1 ^ PARITY)
    a = (np.asarray(x0, np.uint64) + sched[0]) & M32
    b = (np.asarray(x1, np.uint64) + sched[1]) & M32
    for block in range(5):
        for r in ROTATIONS[block % 2]:
            a = (a + b) & M32
            b = _rotl(b, r) ^ a
        a = (a + sched[(block + 1) % 3]) & M32
        b = (b + sched[(block + 2) % 3] + np.uint64(block + 1)) & M32
    return a, b


def root_key(seed: int) -> np.ndarray:
    """The key of a seed of up to 64 bits: words (seed >> 32, seed)."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.int64)


def split(key, n: int) -> np.ndarray:
    """n keys [..., n, 2] from keys [..., 2]; key i does not depend on n."""
    key = np.asarray(key, np.int64)
    i = np.arange(n, dtype=np.uint64)
    a, b = threefry2x32((key[..., 0, None], key[..., 1, None]), np.zeros_like(i), i)
    return np.stack([a, b], -1).astype(np.int64)


def population_keys(seed: int, n: int) -> np.ndarray:
    """The first n keys of the seed's population, int64 [n, 2]."""
    return split(root_key(seed), n)


def bits(key, shape) -> np.ndarray:
    """32 random bits (uint64 holding u32) for every element of ``shape``,
    [..., *shape] for keys [..., 2], drawn row-major."""
    key = np.asarray(key, np.int64)
    n = int(np.prod(shape))
    i = np.arange(n, dtype=np.uint64)
    a, b = threefry2x32((key[..., 0, None], key[..., 1, None]), np.zeros_like(i), i)
    return (a ^ b).reshape(key.shape[:-1] + tuple(shape))


def unit_uniform(key, shape) -> np.ndarray:
    """Uniforms on [0, 1) from the top 23 bits, exact in float64."""
    return (bits(key, shape) >> np.uint64(9)).astype(np.float64) / float(1 << 23)


def uniform(key, shape, lo, hi, dtype=np.float32) -> np.ndarray:
    """Uniforms on [lo, hi): f (hi - lo) + lo rounded once to ``dtype``
    (lo and hi taken in float32, as a float32 configuration states them),
    and never below lo."""
    lo = np.asarray(lo, np.float32).astype(np.float64)
    hi = np.asarray(hi, np.float32).astype(np.float64)
    f = unit_uniform(key, shape)
    return np.maximum(lo, f * (hi - lo) + lo).astype(dtype)


def standard_normal(key, shape) -> np.ndarray:
    """Normals sqrt(2) erfinv(u), u uniform on (-1, 1) as float32 draws it,
    erfinv in float64."""
    import torch

    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0).astype(np.float64)
    return np.sqrt(2.0) * torch.erfinv(torch.from_numpy(u)).numpy()

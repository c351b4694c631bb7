"""The threefry2x32 key stream of ``jax.random`` in its non-partitionable
mode, in numpy: the stream that the tempering engine draws its accept and
exchange uniforms from. Written from the algorithm (Salmon et al., SC'11,
and ``jax.random``'s key and counter layout); ``uint32`` arithmetic wraps
as the cipher's does.

* ``prng_key(seed)`` -> ``[2]`` words (the seed's high and low words),
* ``split(key, num)`` -> ``[num, 2]``,
* ``uniform(key, n)`` -> ``[n]`` float64 in ``[0, 1)``: 64 bits a value
  (the high word from the first half of the hashed counters, the low word
  from the second), the top 52 kept as ``mantissa * 2**-52``.
"""
from __future__ import annotations

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_M32 = 0xFFFFFFFF


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry_2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """20 rounds, the key schedule injected every 4."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    with np.errstate(over="ignore"):
        x0 = x0.astype(np.uint32) + ks[0]
        x1 = x1.astype(np.uint32) + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _hash_counts(key: np.ndarray, n: int) -> np.ndarray:
    half = (n + 1) // 2
    cnt = np.arange(2 * half, dtype=np.uint32)
    cnt[n:] = 0
    y0, y1 = threefry_2x32(key, cnt[:half], cnt[half:])
    return np.concatenate([y0, y1])[:n]


def prng_key(seed: int) -> np.ndarray:
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & _M32], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    return _hash_counts(key, 2 * num).reshape(num, 2)


def uniform(key: np.ndarray, n: int) -> np.ndarray:
    bits = _hash_counts(key, 2 * n).astype(np.uint64)
    hi, lo = bits[:n], bits[n:]
    mant = (hi << np.uint64(20)) | (lo >> np.uint64(12))
    return mant.astype(np.float64) * 2.0 ** -52

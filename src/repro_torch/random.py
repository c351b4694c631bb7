"""jax's threefry2x32 key stream in torch, bit for bit.

The reference search draws every random number through ``jax.random``
with the threefry2x32 PRNG in its *non-partitionable* mode (the mode the
checked-in goldens were recorded in). Replaying a search therefore needs
the same bits, not just the same distribution. This module reproduces

* ``PRNGKey(seed)``   -> ``[2]`` key words,
* ``split(key, n)``   -> ``[n, 2]`` keys,
* ``fold_in(key, d)`` -> ``[2]`` key,
* ``uniform(key, shape)`` -> float64 in ``[0, 1)``,
* ``randint(key, shape, minval, maxval)`` -> int32,

exactly as ``jax.random`` computes them with
``jax_threefry_partitionable=False``.

Every function also takes a leading batch of keys, ``[S, 2]``, and
returns what ``jax.vmap`` of the same call returns (``split`` ->
``[S, n, 2]``, ``fold_in`` -> ``[S, 2]``, ``uniform`` ->
``[S, *shape]``) from one pass over all S keys, so the number of
kernels does not grow with S. ``fold_in`` also takes a ``[S]`` tensor of
counters for one key: the vmap over the data, ``[S, 2]``.

Keys are int64 tensors holding uint32 words. All arithmetic runs on
int64 and is masked back to 32 bits after every add and shift (torch's
``>>`` on int64 is arithmetic, and its uint32 coverage is thin), so the
same code runs on the CPU and on CUDA, and the key stays on the device
it was made on. On the host (checkpoints, the serving layer's slot
state) the words are ``uint32`` arrays, as the reference stores them:
:func:`key_to_np` / :func:`key_from_np`.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from repro_torch.runtime import trace

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

DeviceLike = Union[str, torch.device, None]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def _key_words(key: torch.Tensor):
    """The two key words; a ``[S, 2]`` batch gives ``[S, 1]`` columns
    that broadcast over each key's ``[S, m]`` counters."""
    if key.dim() == 1:
        return key[0], key[1]
    return key[:, 0:1], key[:, 1:2]


def threefry_2x32(key: torch.Tensor, x0: torch.Tensor,
                  x1: torch.Tensor):
    """The threefry2x32 block cipher on two equal-shape word arrays
    (20 rounds, key schedule injected every 4 rounds). A ``[S, 2]`` key
    batch hashes ``[S, m]`` (or broadcastable ``[m]``) words per key."""
    k0, k1 = _key_words(key)
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _hash_counts(key: torch.Tensor, n: int) -> torch.Tensor:
    """``threefry_2x32(key, iota(n))``: the counter array (an odd one
    padded with a zero) is cut into halves, hashed pairwise and the
    halves concatenated, the pad's word dropped (``[n]``, or ``[S, n]``
    for a key batch)."""
    half = (n + 1) // 2
    cnt = torch.arange(2 * half, dtype=torch.int64, device=key.device)
    cnt[n:] = 0
    y0, y1 = threefry_2x32(key, cnt[:half], cnt[half:])
    return torch.cat([y0, y1], dim=-1)[..., :n]


def PRNGKey(seed: int, device: DeviceLike = "cpu") -> torch.Tensor:
    """Key words of ``jax.random.PRNGKey(seed)`` (64-bit seed split into
    its high and low words)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    with trace.synced("upload"):
        return torch.tensor([s >> 32, s & _M32], dtype=torch.int64,
                            device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> ``[num, 2]`` (``[S, num, 2]``
    for a key batch)."""
    return _hash_counts(key, 2 * num).reshape(*key.shape[:-1], num, 2)


def fold_in(key: torch.Tensor,
            data: Union[int, torch.Tensor]) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the key hashed with the counter
    pair ``(0, data)``. A ``[S, 2]`` key batch folds the same ``data``
    into each key; a ``[S]`` int64 tensor of ``data`` folds each counter
    into the one ``[2]`` key. Both give ``[S, 2]``."""
    if isinstance(data, torch.Tensor):
        x1 = data.to(torch.int64) & _M32
        y0, y1 = threefry_2x32(key, torch.zeros_like(x1), x1)
        return torch.stack([y0, y1], dim=-1)
    x0 = torch.zeros(1, dtype=torch.int64, device=key.device)
    x1 = torch.full((1,), int(data) & _M32, dtype=torch.int64,
                    device=key.device)
    y0, y1 = threefry_2x32(key, x0, x1)
    return torch.cat([y0, y1], dim=-1)


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype=float64)``.

    jax draws 64 random bits per value (the high word from the first
    half of the hashed counters, the low word from the second half) and
    keeps the top 52 as the mantissa of a number in ``[1, 2)``, minus
    one. That is exactly ``mantissa * 2**-52``, which is what is
    computed here. A ``[S, 2]`` key batch gives ``[S, *shape]``."""
    shape = tuple(key.shape[:-1]) + tuple(int(s) for s in shape)
    size = math.prod(shape[key.dim() - 1:])
    if size == 0:
        return torch.zeros(shape, dtype=torch.float64, device=key.device)
    bits = _hash_counts(key, 2 * size)
    hi, lo = bits[..., :size], bits[..., size:]
    mant = (hi << 20) | (lo >> 12)
    return (mant.to(torch.float64) * 2.0 ** -52).reshape(shape)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)`` for
    a ``[2]`` key and ``minval < maxval`` within int32.

    jax splits the key in two and draws 32 bits a value from each (the
    higher and the lower bits), then reduces the 64-bit number modulo
    the span as ``(hi % span) * m + lo % span`` with ``m = (2**16 %
    span)**2 % span``, every product and sum wrapping at 32 bits as its
    uint32 arithmetic does (so ``m`` is 0 once the span exceeds
    2**16)."""
    if not minval < maxval:
        raise ValueError(f"randint needs minval < maxval, got "
                         f"[{minval}, {maxval})")
    shape = tuple(int(s) for s in shape)
    size = math.prod(shape)
    k1, k2 = split(key)
    hi, lo = _hash_counts(k1, size), _hash_counts(k2, size)
    span = maxval - minval
    mult = (2 ** 16 % span) ** 2 % span if span <= 2 ** 16 else 0
    off = (((hi % span) * mult) & _M32) + lo % span
    off = (off & _M32) % span
    return (off + minval).to(torch.int32).reshape(shape)


def uniform_cells(keys: torch.Tensor, rows: int, n: int) -> torch.Tensor:
    """``uniform(keys[s], (rows, n))`` for each of S keys, laid out as one
    ``[rows, S*n]`` matrix: row i, columns ``s*n .. s*n + n - 1`` hold
    key s's row i. Value k of a key hashes the counter pair ``(k, k +
    rows*n)``, as :func:`uniform` does; here the counters are broadcast
    against the ``[S, 1]`` key words in this layout, so no copy
    transposes the draws and the work does not grow in kernels with
    S."""
    size = int(rows) * int(n)
    cnt = torch.arange(size, dtype=torch.int64,
                       device=keys.device).reshape(rows, 1, n)
    hi, lo = threefry_2x32(keys, cnt, cnt + size)
    mant = (hi << 20) | (lo >> 12)
    return (mant.to(torch.float64) * 2.0 ** -52).reshape(rows, -1)


def key_to_np(key: torch.Tensor) -> np.ndarray:
    """The key words on the host as ``uint32`` (``[2]`` or ``[S, 2]``),
    the dtype the reference checkpoints its RNG stream position in."""
    return trace.fetch(key, "key").numpy().astype(np.uint32)


def key_from_np(words, device: DeviceLike = "cpu") -> torch.Tensor:
    """Key words saved by :func:`key_to_np` (or by the reference) back as
    this module's int64 key tensor on ``device``."""
    with trace.synced("upload"):
        return torch.as_tensor(np.asarray(words, dtype=np.uint32)
                               .astype(np.int64), device=device)

"""Plain torch version of the RG-LRU gated linear recurrence.

Per batch row and channel, for t = 0 .. T-1:

    h_t = a_t * h_{t-1} + b_t

from ``h_{-1} = h0`` (zeros when ``h0`` is None), with the decay a_t and
the pre-gated input b_t computed by the RecurrentGemma layer. This is
the function the serving path needs: the JAX package's ``_assoc_scan``
(``models/rglru.py``), which takes a start state; with ``h0=None`` it is
the JAX package's Pallas kernel ``rglru_pallas``. The loop rounds the
product and then the sum (two roundings, no fused multiply-add); it is
the CPU path of :func:`repro_torch.kernels.rglru.rglru` and the oracle
the CUDA kernel is held to, bit for bit, on the card.

:func:`rglru_assoc_plain` computes the same recurrence from zeros in
the order of an associative scan (the JAX package's
``rglru_assoc_ref``, ``jax.lax.associative_scan``'s recursion): log
depth, with other roundings than the loop.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rglru_plain(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``a, b``: (B, T, C); ``h0``: (B, C) or None for zeros. Returns
    ``(h (B, T, C), h_T (B, C))`` in float32."""
    bsz, t, c = a.shape
    if h0 is None:
        h = torch.zeros((bsz, c), dtype=torch.float32, device=a.device)
    else:
        h = h0.float()
    a, b = a.float(), b.float()
    hs = []
    for i in range(t):
        h = a[:, i] * h
        h = h + b[:, i]
        hs.append(h)
    return torch.stack(hs, 1), h


def _combine(x, y):
    """(a1, b1) then (a2, b2): (a2 a1, a2 b1 + b2)."""
    (a1, b1), (a2, b2) = x, y
    return a2 * a1, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Rows of ``even`` and ``odd`` alternating along dim 1, from
    ``even``'s first."""
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1])
                         + even.shape[2:])
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _assoc_scan(elems):
    """``jax.lax.associative_scan(_combine, elems, axis=1)``'s recursion:
    combine adjacent pairs, scan them, then fill in the even places."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    odd = _assoc_scan(_combine([e[:, 0:-1:2] for e in elems],
                               [e[:, 1::2] for e in elems]))
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd],
                        [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def rglru_assoc_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a, b``: (B, T, C) -> h (B, T, C) from a zero state, by the
    associative scan of the module docstring, in float32 (returned in
    ``a``'s dtype, as the JAX package's)."""
    return _assoc_scan([a.float(), b.float()])[1].to(a.dtype)

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

"""Plain torch version of the RWKV-6 (Finch) WKV recurrence.

Per row g of G = batch x heads, with key/value width D:

    kv_t    = k_t v_t^T                        (D_k x D_v)
    y_t     = r_t . (S_t + diag(u) kv_t)       (readout, current-token bonus u)
    S_{t+1} = diag(w_t) S_t + kv_t             (data-dependent decay w_t)

starting from ``S_0 = s0`` (zeros when ``s0`` is None). This is the
function the serving path needs: the JAX package's ``wkv_scan``
(``models/rwkv6.py``), which takes and returns the state; with
``s0=None`` and the state dropped it is the JAX package's Pallas kernel
``wkv6_pallas``. The loop steps through T in the reference's order of
operations; it is the CPU path of :func:`repro_torch.kernels.wkv6.wkv6`
and the yardstick the CUDA kernel is held to on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               s0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``r, k, v, w``: (G, T, D); ``u``: (H_u, D) with G a multiple of
    H_u, row g reading ``u[g % H_u]`` (so a per-head ``u`` of shape
    (H, D) serves rows g = b*H + h); ``s0``: (G, D, D) indexed
    [g, k, v], or None for zeros. Returns ``(y (G, T, D), S_T (G, D, D))``
    in float32.

    The model's layout is taken too: ``r, k, v, w`` (B, T, H, D) with
    rows g = b*H + h and ``s0`` (B, H, D, D) give ``y (B, T, H, D)`` and
    ``S_T (B, H, D, D)``, by the same steps on the rows."""
    if r.dim() == 4:
        b, t, h, d = r.shape

        def rows(x):
            return x.permute(0, 2, 1, 3).reshape(b * h, t, d)

        y, s = wkv6_plain(rows(r), rows(k), rows(v), rows(w), u,
                          None if s0 is None else s0.reshape(b * h, d, d))
        return (y.reshape(b, h, t, d).permute(0, 2, 1, 3).contiguous(),
                s.reshape(b, h, d, d))
    g, t, d = r.shape
    uu = u.float().repeat(g // u.shape[0], 1)[:, :, None]       # (G, Dk, 1)
    if s0 is None:
        s = torch.zeros((g, d, d), dtype=torch.float32, device=r.device)
    else:
        s = s0.float()
    r, k, v, w = (x.float() for x in (r, k, v, w))
    ys = []
    for i in range(t):
        kv = k[:, i, :, None] * v[:, i, None, :]                 # (G, Dk, Dv)
        ys.append((r[:, i, :, None] * (s + uu * kv)).sum(1))
        s = w[:, i, :, None] * s + kv
    return torch.stack(ys, 1), s

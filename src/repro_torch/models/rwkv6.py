"""RWKV-6 (Finch) blocks: data-dependent token-shift time mix + channel mix.

The torch counterpart of the JAX package's ``models/rwkv6.py``
[arXiv:2404.05892]: the time-mix block derives its five projections (r,
k, v, w-decay, gate) from data-dependent lerps between the token and its
predecessor (the low-rank "ddlerp"), runs the WKV recurrence with
per-channel data-dependent decay, applies an RMS "head norm" over the
whole width, and gates the output. The channel-mix block is a
squared-ReLU MLP with receptance gating.

The WKV recurrence runs through :func:`repro_torch.kernels.wkv6.wkv6`:
the hand-written CUDA kernel for CUDA tensors, its plain torch version
for CPU tensors. In training (no start state) the call goes through the
wrapper's autograd node; the in-place state write is the decode path's
alone.

Parameters live on :class:`TimeMix` / :class:`ChannelMix` modules under
the JAX package's parameter names; the ``*_forward`` functions read them
as attributes, so they take either module.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.models.common import (
    DTypePolicy,
    FrozenParams,
    init_rms_norm,
    normal_init,
    rms_norm,
)

Params = Dict[str, torch.Tensor]

LORA_RANK = 32
HEAD_DIM = 64


def n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // HEAD_DIM


def init_time_mix(cfg: ModelConfig, policy: DTypePolicy,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> Params:
    d = cfg.d_model
    h = n_heads(cfg)
    dt = policy.param_dtype

    def normal(shape, scale, dtype=dt):
        return normal_init(shape, scale, dtype, generator, device)

    def full(shape, value):
        return torch.full(shape, value, dtype=dt, device=device)

    return {
        # ddlerp: base mixes + shared lora (d -> 5*rank -> d per target)
        "mu_x": full((d,), 0.5),
        "mu": full((5, d), 0.5),
        "lora_a": normal((d, 5 * LORA_RANK), 0.1),
        "lora_b": normal((5, LORA_RANK, d), 0.1),
        # projections
        "w_r": normal((d, d), 1.0),
        "w_k": normal((d, d), 1.0),
        "w_v": normal((d, d), 1.0),
        "w_g": normal((d, d), 1.0),
        "w_o": normal((d, d), 1.0),
        # decay: w0 + lora_w(x)
        "w0": full((d,), -6.0),
        "decay_a": normal((d, LORA_RANK * 2), 0.1),
        "decay_b": normal((LORA_RANK * 2, d), 0.1),
        # current-token bonus
        "u": normal((h, HEAD_DIM), 0.5, torch.float32),
        # head norm (over the whole width)
        "gn": init_rms_norm(d, dt, device),
    }


def init_channel_mix(cfg: ModelConfig, policy: DTypePolicy,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    dt = policy.param_dtype
    return {
        "mu_k": torch.full((d,), 0.5, dtype=dt, device=device),
        "mu_r": torch.full((d,), 0.5, dtype=dt, device=device),
        "w_k": normal_init((d, f), 1.0, dt, generator, device),
        "w_v": normal_init((f, d), 1.0, dt, generator, device),
        "w_r": normal_init((d, d), 1.0, dt, generator, device),
    }


def _shift(x: torch.Tensor, last: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """Previous-token sequence; position 0 sees ``last`` (decode carry) or
    zeros."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([first.to(x.dtype), x[:, :-1]], dim=1)


def _shifted(x: torch.Tensor, last: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """:func:`_shift`, on DTensors per rank over the whole sequence."""
    args, tpl = (x,), ((shd.DATA, None, None),)
    if last is not None:
        args, tpl = args + (last,), tpl + ((shd.DATA, None),)
    return shd.local_call(_shift, args, tpl, (((0, 0), None, None),))


def _ddlerp(p, x: torch.Tensor, x_prev: torch.Tensor):
    """Data-dependent lerp producing the five mixed inputs (r,k,v,w,g)."""
    sx = x_prev - x                                            # (B,S,D)
    base = x + sx * p.mu_x
    lo = shd.constrain(torch.tanh(base @ p.lora_a), (shd.DATA, None, None))
    lo = lo.reshape(*lo.shape[:-1], 5, LORA_RANK)
    adj = torch.einsum("bsir,ird->bsid", lo, p.lora_b)         # (B,S,5,D)
    mixed = x[:, :, None] + sx[:, :, None] * (p.mu + adj)
    return tuple(mixed[:, :, i] for i in range(5))             # r,k,v,w,g


def _decay(p, xw: torch.Tensor) -> torch.Tensor:
    """Per-channel data-dependent decay in (0, 1), computed in float32."""
    lo = torch.tanh(xw @ p.decay_a)
    dw = lo @ p.decay_b
    return torch.exp(-torch.exp((p.w0 + dw).float()))


def wkv_scan(r, k, v, w, u, s0=None):
    """The recurrence over (B, S, H, Dh) tensors; returns (y, final S).

    S has shape (B, H, Dh_k, Dh_v); the u-bonus adds u[k]*k_t[k]*v_t[v]
    for the current token only. The kernel reads r, k, v, w and writes y
    in this layout as it lies, rows g = b*H + h. When ``s0`` is given
    (the decode cache's slab) the final state overwrites it in place and
    is returned; without it the result takes gradients."""
    return wkv6_ops.wkv6(r.float(), k.float(), v.float(), w.float(),
                         u.float(), s0, s_out=s0)


def _wkv_heads(r, k, v, w, u, s0=None):
    """The recurrence on flat (B, S, H*Dh) projections of the heads one
    rank holds (all of them on one device); returns (y (B, S, H*Dh)
    float32, final state)."""
    b, s, _ = r.shape
    r, k, v, w = (t.reshape(b, s, -1, HEAD_DIM) for t in (r, k, v, w))
    y, state = wkv_scan(r, k, v, w, u, s0)
    return y.reshape(b, s, -1), state


def time_mix_forward(p, x: torch.Tensor, cfg: ModelConfig,
                     state: Optional[Tuple] = None):
    """x: (B, S, D). state = (last_x (B,D), wkv_state (B,H,Dh,Dh)) for
    decode continuation, whose wkv slab is updated in place; returns
    (y, new_state)."""
    x = shd.whole_seq(x)
    last_x = None if state is None else state[0]
    x_prev = _shifted(x, last_x)
    xr, xk, xv, xw, xg = _ddlerp(p, x, x_prev)
    r, k, v = xr @ p.w_r, xk @ p.w_k, xv @ p.w_v
    g = F.silu(xg @ p.w_g)
    w = _decay(p, xw)

    s0 = None if state is None else state[1]
    hd = shd.model_split(n_heads(cfg), r)
    row = (shd.DATA, None, hd)
    args = (r, k, v, w, p.u) + (() if s0 is None else (s0,))
    tpl = (row,) * 4 + ((hd, None),) + (
        () if s0 is None else ((shd.DATA, hd, None, None),))
    y, wkv_state = shd.local_call(
        _wkv_heads, args, tpl,
        (((0, 0), None, (0, 2)), ((0, 0), (0, 2), None, None)))
    y = y.to(x.dtype)
    y = rms_norm(y, p.gn)                                      # head norm
    y = shd.constrain_residual((y * g) @ p.w_o)
    return y, (x[:, -1].clone(), wkv_state)


def channel_mix_forward(p, x: torch.Tensor,
                        state: Optional[torch.Tensor] = None):
    """state = last_x (B, D); returns (y, new_state)."""
    x = shd.whole_seq(x)
    x_prev = _shifted(x, state)
    xk = x + (x_prev - x) * p.mu_k
    xr = x + (x_prev - x) * p.mu_r
    k = torch.square(torch.relu(xk @ p.w_k))
    kv = k @ p.w_v
    r = torch.sigmoid(xr @ p.w_r)
    return shd.constrain_residual(r * kv), x[:, -1].clone()


class TimeMix(FrozenParams):
    def __init__(self, cfg: ModelConfig, policy: DTypePolicy = DTypePolicy(),
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(init_time_mix(cfg, policy, generator, device))
        self.cfg = cfg

    def forward(self, x, state=None):
        return time_mix_forward(self, x, self.cfg, state)


class ChannelMix(FrozenParams):
    def __init__(self, cfg: ModelConfig, policy: DTypePolicy = DTypePolicy(),
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(init_channel_mix(cfg, policy, generator, device))

    def forward(self, x, state=None):
        return channel_mix_forward(self, x, state)

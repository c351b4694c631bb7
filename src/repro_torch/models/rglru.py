"""RecurrentGemma / Griffin recurrent block: temporal conv + RG-LRU.

The torch counterpart of the JAX package's ``models/rglru.py``
[arXiv:2402.19427]. Block structure:

    gate branch : x -> linear(d -> w) -> GeLU (tanh approximation)
    input branch: x -> linear(d -> w) -> causal depthwise conv1d(width 4)
                    -> RG-LRU
    merge       : gate * lru_out -> linear(w -> d)

RG-LRU (block-diagonal gates over 16 blocks, as in the released model):

    r_t = sigmoid(Wa xi_t);  i_t = sigmoid(Wx xi_t)
    a_t = exp(-c * softplus(Lambda) * r_t)              (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * xi_t)

The scan runs through :func:`repro_torch.kernels.rglru.rglru`: the
hand-written CUDA kernel for CUDA tensors, its plain torch version for
CPU tensors. The JAX package scans with its jnp associative scan. In
training (no start state) the call goes through the wrapper's autograd
node, whose backward runs the same kernel over the reversed sequence;
the in-place state write is the decode path's alone. On DTensors the
conv and the scan run on each rank's channels (over ``model`` when it
divides the gate blocks) over the whole sequence, as local tensors.

Parameters live on an :class:`RGBlock` module under the JAX package's
parameter names; the functions read them as attributes.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

import types

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.models.common import DTypePolicy, FrozenParams, normal_init

Params = Dict[str, torch.Tensor]

RG_C = 8.0
N_GATE_BLOCKS = 16


def init_rg_block(cfg: ModelConfig, policy: DTypePolicy,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> Params:
    d = cfg.d_model
    w = cfg.rg_lru_width or d
    bw = w // N_GATE_BLOCKS
    dt = policy.param_dtype

    def normal(shape):
        return normal_init(shape, 1.0, dt, generator, device)

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=device)

    # Lambda in [0.2, 0.9), so a is stable in (0.9, 0.999) at init; float32
    # whatever the policy
    lam = torch.rand((w,), generator=generator, dtype=torch.float32,
                     device=device) * 0.7 + 0.2
    return {
        "w_in": normal((d, w)),
        "w_gate": normal((d, w)),
        "conv_w": normal((cfg.rg_conv_width, w)),
        "conv_b": zeros(w),
        "gate_a": normal((N_GATE_BLOCKS, bw, bw)),
        "gate_a_b": zeros(w),
        "gate_x": normal((N_GATE_BLOCKS, bw, bw)),
        "gate_x_b": zeros(w),
        "lam": lam,
        "w_out": normal((w, d)),
    }


def _block_diag(x: torch.Tensor, wts: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """x: (..., W) with W = H*bw; wts: (H, bw, bw)."""
    h, bw, _ = wts.shape
    xb = x.reshape(*x.shape[:-1], h, bw)
    out = torch.einsum("...hb,hbc->...hc", xb, wts)
    return out.reshape(x.shape) + bias


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over (B, S, W); kernel (K, W). ``state`` is
    the trailing K-1 inputs of the previous segment (decode carry). The
    taps are summed in order 0 .. K-1, then the bias added. Returns
    (y, new_state)."""
    k = w.shape[0]
    s = x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    # a copy: a view would keep the whole (B, K-1+S, W) input alive
    return y + b, xp[:, -(k - 1):].clone()


def _rg_lru_coeffs(p, xi: torch.Tensor):
    """The decay a and the gated input b of the recurrence, float32."""
    r = torch.sigmoid(_block_diag(xi, p.gate_a, p.gate_a_b))
    i = torch.sigmoid(_block_diag(xi, p.gate_x, p.gate_x_b))
    log_a = -RG_C * F.softplus(p.lam) * r.float()
    a = torch.exp(log_a)
    # sqrt(1 - a^2) computed via log, as the JAX package does
    mult = torch.exp(0.5 * torch.log1p(-torch.exp(2 * log_a) + 1e-12))
    b = mult * (i.float() * xi.float())
    return a, b


def rg_block_forward(p, x: torch.Tensor, cfg: ModelConfig,
                     state: Optional[Tuple] = None):
    """x: (B, S, D). state = (conv_state (B, K-1, W), h (B, W) float32)
    or None; a given ``h`` is the decode cache's slab and is overwritten
    in place by the final state. Returns (y, (new_conv, h_T))."""
    x = shd.whole_seq(x)
    gate = F.gelu(x @ p.w_gate, approximate="tanh")
    xi = x @ p.w_in
    cw = shd.model_split(N_GATE_BLOCKS, xi)
    args = (xi,) + tuple(getattr(p, n) for n in _SCAN_PARAMS)
    tpl = ((shd.DATA, None, cw), (None, cw), (cw,), (cw, None, None), (cw,),
           (cw, None, None), (cw,), (cw,))
    if state is not None:
        args += tuple(state)
        tpl += ((shd.DATA, None, cw), (shd.DATA, cw))
    h, new_conv, h_t = shd.local_call(
        _conv_scan, args, tpl,
        (((0, 0), None, (0, 2)), ((0, 0), None, (0, 2)), ((0, 0), (0, 2))))
    y = shd.constrain_residual((h.to(x.dtype) * gate) @ p.w_out)
    return y, (new_conv, h_t)


_SCAN_PARAMS = ("conv_w", "conv_b", "gate_a", "gate_a_b", "gate_x",
                "gate_x_b", "lam")


def _conv_scan(xi, conv_w, conv_b, gate_a, gate_a_b, gate_x, gate_x_b, lam,
               conv_state=None, h0=None):
    """The conv and the RG-LRU of the channels one rank holds (all of
    them on one device): returns (h (B, S, W) float32, new conv state,
    final h); a given ``h0`` is overwritten in place."""
    xi, new_conv = _causal_conv(xi, conv_w, conv_b, conv_state)
    p = types.SimpleNamespace(gate_a=gate_a, gate_a_b=gate_a_b,
                              gate_x=gate_x, gate_x_b=gate_x_b, lam=lam)
    a, b = _rg_lru_coeffs(p, xi)
    h, h_t = rglru_ops.rglru(a, b, h0, h_out=h0)
    return h, new_conv, h_t


class RGBlock(FrozenParams):
    def __init__(self, cfg: ModelConfig, policy: DTypePolicy = DTypePolicy(),
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(init_rg_block(cfg, policy, generator, device))

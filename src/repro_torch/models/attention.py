"""Attention, forward only: grouped-query attention (GQA, MQA) with an
optional sliding window, as the hybrid family's local-attention layers
use it.

The torch counterpart of the JAX package's ``models/attention.py`` for
that path. The full-sequence path is a chunked flash-style attention:
an online softmax over KV chunks inside a loop over Q chunks, with the
JAX package's additive ``NEG_INF`` mask and its causal/window chunk
skipping, so no (S, S) score matrix is ever formed. The decode path
attends a single query against the cache. The JAX package computes all
of this in plain jnp (no Pallas kernel), and so does the port in plain
torch: matrix products for the chunk products, elementwise ops for the
softmax.

Shapes: x (B, S, D); q (B, S, KV, G, Dh) grouped, so KV heads are never
repeated; caches (B, T, KV, Dh). QKV bias, qk-norm, MLA and the flash
backward are not ported.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (
    DTypePolicy,
    FrozenParams,
    apply_rope,
    normal_init,
)

Params = Dict[str, torch.Tensor]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Chunked (flash-style) attention core
# ---------------------------------------------------------------------------


def _attend_chunk(q, k, v, bias, scale):
    """q: (B, qc, KV, G, Dh); k/v: (B, kc, KV, Dh); bias: f32 (qc, kc)
    additive mask (0 / NEG_INF). Returns (scores_max, exp_scores@v,
    exp_sums) for the online softmax, each (B, KV, G, qc[, Dh])."""
    b, qc, kvh, g, dh = q.shape
    qg = q.permute(0, 2, 3, 1, 4).reshape(b, kvh, g * qc, dh)
    s = (qg @ k.permute(0, 2, 3, 1)).float() * scale          # (B,KV,G*qc,kc)
    s = s.reshape(b, kvh, g, qc, -1) + bias
    m = s.amax(dim=-1)                                        # (B,KV,G,qc)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)                                         # (B,KV,G,qc)
    o = p.to(v.dtype).reshape(b, kvh, g * qc, -1) @ v.transpose(1, 2)
    return m, o.float().reshape(b, kvh, g, qc, dh), l


def _chunk_mask(q_pos, k_pos, window, t):
    """f32 additive bias (qc, kc): 0 where attended, NEG_INF where masked
    (causal, outside the window, or kv padding)."""
    mask = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    mask &= k_pos[None, :] < t                     # kv padding
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(mask, zero, NEG_INF)


def chunked_attention(
    q: torch.Tensor,       # (B, S, KV, G, Dh)
    k: torch.Tensor,       # (B, T, KV, Dh)
    v: torch.Tensor,       # (B, T, KV, Dh)
    *,
    window: Optional[int] = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Causal flash attention forward (online softmax over KV chunks),
    with q and k at the same positions; returns (B, S, KV, G, Dh) in
    v.dtype. The KV chunks a Q chunk cannot see (after its last row,
    before its window) are skipped."""
    b, s, kvh, g, dh = q.shape
    t = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, t)
    nq = -(-s // q_chunk)
    nkv = -(-t // kv_chunk)
    qp = nq * q_chunk - s
    kp = nkv * kv_chunk - t
    if qp:
        q = torch.cat([q, q.new_zeros((b, qp) + q.shape[2:])], dim=1)
    if kp:
        k = torch.cat([k, k.new_zeros((b, kp) + k.shape[2:])], dim=1)
        v = torch.cat([v, v.new_zeros((b, kp) + v.shape[2:])], dim=1)
    q_pos_base = torch.arange(q_chunk, device=q.device)
    k_pos_base = torch.arange(kv_chunk, device=q.device)
    outs = []
    for qi in range(nq):
        q_blk = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        m = torch.full((b, kvh, g, q_chunk), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        o = torch.zeros((b, kvh, g, q_chunk, dh), dtype=torch.float32,
                        device=q.device)
        hi = min(nkv, ((qi + 1) * q_chunk - 1) // kv_chunk + 1)
        lo = 0
        if window is not None:
            lo = max(lo, (qi * q_chunk - window + 1) // kv_chunk)
        for ki in range(lo, hi):
            k_blk = k[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            v_blk = v[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            q_pos = qi * q_chunk + q_pos_base
            k_pos = ki * kv_chunk + k_pos_base
            mask = _chunk_mask(q_pos, k_pos, window, t)
            mc, oc, lc = _attend_chunk(q_blk, k_blk, v_blk, mask, scale)
            m_new = torch.maximum(m, mc)
            a_old = torch.exp(m - m_new)
            a_new = torch.exp(mc - m_new)
            l = l * a_old + lc * a_new
            o = o * a_old[..., None] + oc * a_new[..., None]
            m = m_new
        out = o / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))       # (B, qc, KV, G, Dh)
    return torch.cat(outs, dim=1)[:, :s].to(v.dtype)


def decode_attention(q1, k, v, *, length):
    """Single-token attention: q1 (B, KV, G, Dh) vs cache k/v
    (B, T, KV, Dh); cache positions >= ``length`` (B,) are masked."""
    b, kvh, g, dh = q1.shape
    t = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    s = (q1 @ k.permute(0, 2, 3, 1)).float() * scale          # (B,KV,G,T)
    mask = torch.arange(t, device=k.device)[None] < length[:, None]
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = p.to(v.dtype) @ v.transpose(1, 2)                   # (B,KV,G,Dh)
    return out.to(v.dtype)


# ---------------------------------------------------------------------------
# GQA layer (MHA/GQA/MQA, sliding window)
# ---------------------------------------------------------------------------


def init_gqa(cfg: ModelConfig, policy: DTypePolicy,
             generator: Optional[torch.Generator] = None,
             device=None) -> Params:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = policy.param_dtype

    def normal(shape):
        return normal_init(shape, 1.0, dt, generator, device)

    return {"wq": normal((d, h * dh)), "wk": normal((d, kv * dh)),
            "wv": normal((d, kv * dh)), "wo": normal((h * dh, d))}


def _project_qkv(p, x, cfg: ModelConfig):
    b, s, _ = x.shape
    kv, dh = cfg.n_kv_heads, cfg.d_head
    g = cfg.n_heads // kv
    q = (x @ p.wq).reshape(b, s, kv, g, dh)
    k = (x @ p.wk).reshape(b, s, kv, dh)
    v = (x @ p.wv).reshape(b, s, kv, dh)
    return q, k, v


def rope_qk(q, k, positions, cfg: ModelConfig):
    """RoPE on the grouped q (B, S, KV, G, Dh) and on k (B, S, KV, Dh)."""
    b, s = q.shape[:2]
    q = apply_rope(q.reshape(b, s, -1, cfg.d_head), positions,
                   cfg.rope_theta).reshape(q.shape)
    return q, apply_rope(k, positions, cfg.rope_theta)


class GQA(FrozenParams):
    def __init__(self, cfg: ModelConfig, policy: DTypePolicy = DTypePolicy(),
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(init_gqa(cfg, policy, generator, device))

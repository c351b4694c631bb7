"""Attention: grouped-query attention (GQA, MQA) with
qk-norm and QKV bias, over the full causal context (the dense and
Llama-4 layers) or a sliding window (the hybrid family's
local-attention layers), and DeepSeek-V2's multi-head latent attention
(MLA).

The torch counterpart of the JAX package's ``models/attention.py`` for
those paths. The full-sequence path is a chunked flash-style attention:
an online softmax over KV chunks inside a loop over Q chunks, with the
JAX package's additive ``NEG_INF`` mask and its causal/window chunk
skipping, so no (S, S) score matrix is ever formed. The decode path
attends a single query against the cache. The JAX package computes all
of this in plain jnp (no Pallas kernel), and so does the port in plain
torch: matrix products for the chunk products, elementwise ops for the
softmax. Scores, their products with V and the softmax are float32
whatever the input dtype, as the JAX package's
``preferred_element_type=float32`` products are: 16-bit operands are
widened (exactly) before each product.

Shapes: x (B, S, D); q (B, S, KV, G, Dh) grouped, so KV heads are never
repeated; caches (B, T, KV, Dh). MLA's cache is the latent pair
(c_kv (B, T, kv_lora_rank), k_rope (B, T, qk_rope_head_dim)); its
absorbed decode rounds its products to the cache dtype as the JAX
package's (which gives them no ``preferred_element_type``). The flash
backward is the JAX package's custom VJP, as a
``torch.autograd.Function`` (plain torch too: no kernel of either
package has a backward).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models.common import (
    DTypePolicy,
    FrozenParams,
    apply_rope,
    init_rms_norm,
    normal_init,
    rms_norm,
)

Params = Dict[str, torch.Tensor]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Chunked (flash-style) attention core
# ---------------------------------------------------------------------------


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with a float32 result: 16-bit operands are widened
    first (exactly), so the products and sums are float32 (a no-op on
    float32 operands)."""
    return a.float() @ b.float()


def _attend_chunk(q, k, v, bias, scale):
    """q: (B, qc, KV, G, Dh); k/v: (B, kc, KV, Dh); bias: f32 (qc, kc)
    additive mask (0 / NEG_INF). Returns (scores_max, exp_scores@v,
    exp_sums) for the online softmax, each (B, KV, G, qc[, Dh]), all
    float32; the probabilities meet v in v.dtype."""
    b, qc, kvh, g, dh = q.shape
    qg = q.permute(0, 2, 3, 1, 4).reshape(b, kvh, g * qc, dh)
    s = _mm_f32(qg, k.permute(0, 2, 3, 1)) * scale            # (B,KV,G*qc,kc)
    s = s.reshape(b, kvh, g, qc, -1) + bias
    m = s.amax(dim=-1)                                        # (B,KV,G,qc)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)                                         # (B,KV,G,qc)
    o = _mm_f32(p.to(v.dtype).reshape(b, kvh, g * qc, -1),
                v.transpose(1, 2))
    return m, o.reshape(b, kvh, g, qc, dh), l


def _chunk_mask(q_pos, k_pos, causal, window, t):
    """f32 additive bias (qc, kc): 0 where attended, NEG_INF where masked
    (causal, outside the window, or kv padding)."""
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    mask &= k_pos[None, :] < t                     # kv padding
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(mask, zero, NEG_INF)


def _kv_range(qi: int, q_chunk: int, kv_chunk: int, nkv: int, causal,
              window):
    """The KV chunks Q chunk ``qi`` can see: none after its last row when
    causal, none before its window's start."""
    hi = nkv
    if causal:
        hi = min(nkv, ((qi + 1) * q_chunk - 1) // kv_chunk + 1)
    lo = 0
    if window is not None:
        lo = max(lo, (qi * q_chunk - window + 1) // kv_chunk)
    return lo, hi


def _flash_fwd(q, k, v, causal, window, q_chunk, kv_chunk, t,
               with_lse: bool = False):
    """The online-softmax forward on chunk-padded operands: q (B, NQ*qc,
    KV, G, Dh), k and v (B, NK*kc, KV, Dh), the kv positions >= ``t``
    padding. Returns (out float32 of q's shape, the log-sum-exp of each
    row (B, KV, G, NQ*qc) when ``with_lse``, else None)."""
    b, sp, kvh, g, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    nq = sp // q_chunk
    nkv = k.shape[1] // kv_chunk
    q_pos_base = torch.arange(q_chunk, device=q.device)
    k_pos_base = torch.arange(kv_chunk, device=q.device)
    outs, lses = [], []
    for qi in range(nq):
        q_blk = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        m = torch.full((b, kvh, g, q_chunk), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        o = torch.zeros((b, kvh, g, q_chunk, dh), dtype=torch.float32,
                        device=q.device)
        lo, hi = _kv_range(qi, q_chunk, kv_chunk, nkv, causal, window)
        for ki in range(lo, hi):
            k_blk = k[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            v_blk = v[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            q_pos = qi * q_chunk + q_pos_base
            k_pos = ki * kv_chunk + k_pos_base
            mask = _chunk_mask(q_pos, k_pos, causal, window, t)
            mc, oc, lc = _attend_chunk(q_blk, k_blk, v_blk, mask, scale)
            m_new = torch.maximum(m, mc)
            a_old = torch.exp(m - m_new)
            a_new = torch.exp(mc - m_new)
            l = l * a_old + lc * a_new
            o = o * a_old[..., None] + oc * a_new[..., None]
            m = m_new
        out = o / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))       # (B, qc, KV, G, Dh)
        if with_lse:
            lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
    return (torch.cat(outs, dim=1),
            torch.cat(lses, dim=-1) if with_lse else None)


def _flash_bwd(q, k, v, out, lse, dout, causal, window, q_chunk, kv_chunk,
               t):
    """The JAX package's ``_flash_bwd``: each chunk pair's probabilities
    recomputed from the row's log-sum-exp, so no (S, T) matrix is held.
    ``p`` and ``ds`` are rounded to v.dtype before their products, as
    there; every product and accumulator is float32. The chunks the
    forward skips are skipped here too: the JAX package sweeps them, and
    they add exact zeros there (every score is NEG_INF, so p = 0)."""
    b, sp, kvh, g, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    nq = sp // q_chunk
    nkv = k.shape[1] // kv_chunk
    delta = (dout.float() * out.float()).sum(-1)          # (B, sp, KV, G)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    q_pos_base = torch.arange(q_chunk, device=q.device)
    k_pos_base = torch.arange(kv_chunk, device=q.device)

    def rows(x, qi):           # (B, qc, KV, G, ...) -> (B, KV, G*qc, ...)
        x = x[:, qi * q_chunk:(qi + 1) * q_chunk].movedim(1, 3)
        return x.reshape(b, kvh, g * q_chunk, *x.shape[4:])

    dqs = []
    for qi in range(nq):
        qg, dog = rows(q, qi), rows(dout, qi)
        dl = rows(delta, qi)[..., None]
        lse_q = lse[..., qi * q_chunk:(qi + 1) * q_chunk].reshape(
            b, kvh, g * q_chunk, 1)
        dq_c = torch.zeros((b, kvh, g * q_chunk, dh), dtype=torch.float32,
                           device=q.device)
        lo, hi = _kv_range(qi, q_chunk, kv_chunk, nkv, causal, window)
        for ki in range(lo, hi):
            cols = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            k_t = k[:, cols].transpose(1, 2)               # (B, KV, kc, Dh)
            v_t = v[:, cols].transpose(1, 2)
            bias = _chunk_mask(qi * q_chunk + q_pos_base,
                               ki * kv_chunk + k_pos_base, causal, window, t)
            s = _mm_f32(qg, k_t.transpose(2, 3)) * scale  # (B,KV,G*qc,kc)
            s = (s.reshape(b, kvh, g, q_chunk, -1) + bias).reshape(s.shape)
            p = torch.exp(s - lse_q)
            dv_blk = _mm_f32(p.to(v.dtype).transpose(2, 3), dog)
            dp = _mm_f32(dog, v_t.transpose(2, 3))
            ds = (p * (dp - dl) * scale).to(v.dtype)
            dq_c += _mm_f32(ds, k_t)
            dk_blk = _mm_f32(ds.transpose(2, 3), qg)       # (B, KV, kc, Dh)
            dk[:, cols] += dk_blk.transpose(1, 2)
            dv[:, cols] += dv_blk.transpose(1, 2)
        dq_c = dq_c.reshape(b, kvh, g, q_chunk, dh).movedim(3, 1)
        dqs.append(dq_c.to(q.dtype))
    return torch.cat(dqs, dim=1), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    """Flash attention with the JAX package's custom VJP: the forward
    saves (q, k, v, out, lse) and the backward recomputes each chunk's
    probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_chunk, kv_chunk, t):
        out, lse = _flash_fwd(q, k, v, causal, window, q_chunk, kv_chunk,
                              t, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_chunk, kv_chunk, t)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def chunked_attention(
    q: torch.Tensor,       # (B, S, KV, G, Dh)
    k: torch.Tensor,       # (B, T, KV, Dh)
    v: torch.Tensor,       # (B, T, KV, Dh)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Flash attention (online softmax over KV chunks), with q and k at
    the same positions; returns (B, S, KV, G, Dh) in v.dtype. The KV
    chunks a Q chunk cannot see (after its last row when causal, before
    its window) are skipped. When grad is enabled and an operand takes
    one, it runs through :class:`_Flash`, whose backward recomputes the
    chunk probabilities; otherwise it only runs the forward."""
    b, s, kvh, g, dh = q.shape
    t = k.shape[1]
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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out = _Flash.apply(q, k, v, causal, window, q_chunk, kv_chunk, t)
    else:
        out, _ = _flash_fwd(q, k, v, causal, window, q_chunk, kv_chunk, t)
    return out[:, :s].to(v.dtype)


def decode_attention(q1, k, v, *, length):
    """Single-token attention: q1 (B, KV, G, Dh) vs cache k/v
    (B, T, KV, Dh); cache positions >= ``length`` (B,) are masked."""
    b, kvh, g, dh = q1.shape
    t = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    s = _mm_f32(q1, k.permute(0, 2, 3, 1)) * scale            # (B,KV,G,T)
    mask = torch.arange(t, device=k.device)[None] < length[:, None]
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = _mm_f32(p.to(v.dtype), v.transpose(1, 2))           # (B,KV,G,Dh)
    return out.to(v.dtype)


# ---------------------------------------------------------------------------
# GQA layer (MHA/GQA/MQA, qk-norm, QKV bias, sliding window)
# ---------------------------------------------------------------------------


def init_gqa(cfg: ModelConfig, policy: DTypePolicy,
             generator: Optional[torch.Generator] = None,
             device=None) -> Params:
    """The projections, drawn in the order wq, wk, wv, wo; the QKV
    biases (zeros) when ``cfg.qkv_bias`` and the per-head q/k RMS norm
    weights (ones) when ``cfg.qk_norm``, as the JAX package inits them."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = policy.param_dtype

    def normal(shape):
        return normal_init(shape, 1.0, dt, generator, device)

    p = {"wq": normal((d, h * dh)), "wk": normal((d, kv * dh)),
         "wv": normal((d, kv * dh)), "wo": normal((h * dh, d))}
    if cfg.qkv_bias:
        for name, width in (("bq", h * dh), ("bk", kv * dh),
                            ("bv", kv * dh)):
            p[name] = torch.zeros((width,), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(dh, dt, device)
        p["k_norm"] = init_rms_norm(dh, dt, device)
    return p


def _qkv_flat(p, x, cfg: ModelConfig):
    """q (B, S, H*Dh), k and v (B, S, KV*Dh): the projections and the
    biases."""
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return q, k, v


def _qk_norms(p, cfg: ModelConfig) -> tuple:
    return (p.q_norm, p.k_norm) if cfg.qk_norm else ()


def _split_heads(q, k, v, cfg: ModelConfig, *norms):
    """The flat projections as q (B, S, KV, G, Dh), k and v (B, S, KV,
    Dh) (KV the heads this rank holds), then the RMS norm of each head's
    Dh axis when ``norms`` gives its weights."""
    b, s, _ = q.shape
    dh = cfg.d_head
    g = cfg.n_heads // cfg.n_kv_heads
    q = q.reshape(b, s, -1, g, dh)
    k = k.reshape(b, s, -1, dh)
    v = v.reshape(b, s, -1, dh)
    if norms:
        q = rms_norm(q, norms[0])
        k = rms_norm(k, norms[1])
    return q, k, v


def _project_qkv(p, x, cfg: ModelConfig):
    """q (B, S, KV, G, Dh), k and v (B, S, KV, Dh): the projections, the
    biases, then the RMS norm of each head's Dh axis, in the JAX
    package's order (RoPE comes after)."""
    return _split_heads(*_qkv_flat(p, x, cfg), cfg, *_qk_norms(p, cfg))


def rope_qk(q, k, positions, cfg: ModelConfig):
    """RoPE on the grouped q (B, S, KV, G, Dh) and on k (B, S, KV, Dh)."""
    b, s = q.shape[:2]
    q = apply_rope(q.reshape(b, s, -1, cfg.d_head), positions,
                   cfg.rope_theta).reshape(q.shape)
    return q, apply_rope(k, positions, cfg.rope_theta)


def _attend_local(q, k, v, positions, *norms, cfg: ModelConfig, causal,
                  window, q_chunk, kv_chunk):
    """The heads of one rank (all of them on one device): split, normed,
    rotated and attended. Returns (out (B, S, KV*G*Dh), k, v)."""
    b, s, _ = q.shape
    q, k, v = _split_heads(q, k, v, cfg, *norms)
    q, k = rope_qk(q, k, positions, cfg)
    out = chunked_attention(q, k, v, causal=causal, window=window,
                            q_chunk=q_chunk, kv_chunk=kv_chunk)
    return out.reshape(b, s, -1), k, v


def attend(p, x, positions, cfg: ModelConfig, *, causal: bool = True,
           window: Optional[int] = None, q_chunk: int = 512,
           kv_chunk: int = 1024):
    """The attention layer over the full sequence. Returns (y (B, S, D),
    k, v), k and v (B, S, KV, Dh) after RoPE, for a cache. On DTensors
    the heads run per rank: batch over the data axes, KV heads over
    ``model`` when it divides them (the JAX package's constraint on the
    chunked operands)."""
    q, k, v = _qkv_flat(p, shd.whole_seq(x), cfg)
    norms = _qk_norms(p, cfg)
    row = (shd.DATA, None, shd.model_split(cfg.n_kv_heads, q))
    out, k, v = shd.local_call(
        functools.partial(_attend_local, cfg=cfg, causal=causal,
                          window=window, q_chunk=q_chunk,
                          kv_chunk=kv_chunk),
        (q, k, v, positions) + norms,
        (row, row, row, (shd.DATA, None)) + ((None,),) * len(norms),
        (((0, 0), None, (0, 2)), ((1, 0), None, (1, 2), None),
         ((2, 0), None, (2, 2), None)))
    return shd.constrain_residual(out @ p.wo), k, v


def gqa_forward(p, x, positions, cfg: ModelConfig, *, causal: bool = True,
                window: Optional[int] = None, q_chunk: int = 512,
                kv_chunk: int = 1024) -> torch.Tensor:
    return attend(p, x, positions, cfg, causal=causal, window=window,
                  q_chunk=q_chunk, kv_chunk=kv_chunk)[0]


def gqa_prefill(p, x, positions, cfg: ModelConfig, cache_len: int, *,
                q_chunk: int = 512, kv_chunk: int = 1024):
    """Causal attention over the prompt; returns (y, (k, v)), the cache
    right-padded with zeros to ``cache_len`` positions."""
    y, k, v = attend(p, x, positions, cfg, q_chunk=q_chunk,
                     kv_chunk=kv_chunk)
    pad = (0, 0, 0, 0, 0, cache_len - x.shape[1])
    return y, (shd.pad(k, pad), shd.pad(v, pad))


def _write_rows(cache, new, pos, t0, group):
    """Write ``new[i]`` at slot ``pos[i] - t0`` of ``cache`` in place.
    With ``group`` (the slots split over its ranks) a row whose slot is
    not among this rank's ``cache.shape[1]`` writes its slot's own value
    back (clamped into range): no read on the host."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    rel = pos - t0
    if group is None:
        cache[rows, rel] = new
        return
    mine = (rel >= 0) & (rel < cache.shape[1])
    rel = rel.clamp(0, cache.shape[1] - 1)
    keep = mine.reshape(-1, *(1,) * (new.ndim - 1))
    cache[rows, rel] = torch.where(keep, new, cache[rows, rel])


def split_softmax_combine(s, values, group):
    """Softmax over a key axis split over ``group``'s ranks (flash
    decode): ``s`` (..., T_local) float32 scores, ``values(p)`` the
    products of unnormalised probabilities with this rank's values.
    The maxima, sums and products meet in three all-reduces."""
    import torch.distributed._functional_collectives as fc

    m = fc.all_reduce(s.amax(dim=-1), "max", group)
    p = torch.exp(s - m[..., None])
    l_sum = fc.all_reduce(p.sum(dim=-1), "sum", group)
    o = fc.all_reduce(values(p), "sum", group)
    return o, l_sum


def _decode_local(q, k, v, ck, cv, pos, *norms, cfg: ModelConfig, t0,
                  group, window=None):
    """One decode step of one rank's cache slots ``[t0, t0 + T_local)``
    (all of them, ``group`` None, on one device): the new K/V written in
    place where its slot is this rank's, then attention over the slots
    < length, the softmax combined over ``group``. A ring buffer of
    ``window`` slots holds position p at slot ``p % window`` and its
    length is ``min(pos + 1, window)``; a plain cache holds p at slot p
    and its length is ``pos + 1``."""
    b = q.shape[0]
    q, k, v = _split_heads(q, k, v, cfg, *norms)
    q, k = rope_qk(q, k, pos[:, None], cfg)
    slot = pos if window is None else pos % window
    _write_rows(ck, k[:, 0], slot, t0, group)
    _write_rows(cv, v[:, 0], slot, t0, group)
    valid = pos + 1 if window is None else torch.clamp(pos + 1, max=window)
    if group is None:
        out = decode_attention(q[:, 0], ck, cv, length=valid)
        return out.reshape(b, 1, -1)
    q1 = q[:, 0]
    scale = 1.0 / math.sqrt(q1.shape[-1])
    s = _mm_f32(q1, ck.permute(0, 2, 3, 1)) * scale       # (B,KV,G,T_loc)
    idx = torch.arange(ck.shape[1], device=ck.device) + t0
    s = torch.where((idx[None] < valid[:, None])[:, None, None], s, NEG_INF)
    o, l_sum = split_softmax_combine(
        s, lambda p: _mm_f32(p, cv.transpose(1, 2).float()), group)
    return (o / l_sum[..., None]).to(cv.dtype).reshape(b, 1, -1)


def seq_shard(cache_t):
    """(first slot, model group) of this rank's part of a cache DTensor
    whose slot axis (dim 1) is split over ``model``; (0, None) when it
    is not split or not a DTensor."""
    if not shd.is_dtensor(cache_t):
        return 0, None
    mesh = cache_t.device_mesh
    names = list(mesh.mesh_dim_names)
    if "model" not in names:
        return 0, None
    i = names.index("model")
    if not (cache_t.placements[i].is_shard()
            and cache_t.placements[i].dim == 1):
        return 0, None
    t_loc = cache_t.to_local().shape[1]
    return mesh.get_local_rank("model") * t_loc, mesh.get_group("model")


def gqa_decode(p, x1, cache, length, cfg: ModelConfig,
               window: Optional[int] = None):
    """x1 (B, 1, D); cache k/v (B, T, KV, Dh); length (B,) the current
    lengths, each < T. Writes each row's new k/v at its own ``length``
    in place (the JAX package's one-hot blend, which on finite values is
    that write) and attends positions <= length. With ``window`` the
    cache is a ring buffer of that many slots (position p at slot
    ``p % window``; the slots beyond min(length+1, window) masked).
    Returns (y (B, 1, D), the cache). On DTensors each rank writes and
    attends its own slots of the cache (slots over ``model``, batch over
    the data axes) and the softmax is combined over ``model``."""
    ck, cv = cache
    q, k, v = _qkv_flat(p, x1, cfg)
    norms = _qk_norms(p, cfg)
    t0, group = seq_shard(ck)
    row = (shd.DATA, None, None)
    kv_spec = (shd.DATA, "model" if group is not None else None, None, None)
    out = shd.local_call(
        functools.partial(_decode_local, cfg=cfg, t0=t0, group=group,
                          window=window),
        (q, k, v, ck, cv, length.long()) + norms,
        (row, row, row, kv_spec, kv_spec, (shd.DATA,))
        + ((None,),) * len(norms),
        (((0, 0), None, None),))
    return shd.constrain_residual(out @ p.wo), (ck, cv)


class GQA(FrozenParams):
    def __init__(self, cfg: ModelConfig, policy: DTypePolicy = DTypePolicy(),
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(init_gqa(cfg, policy, generator, device))


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


def init_mla(cfg: ModelConfig, policy: DTypePolicy,
             generator: Optional[torch.Generator] = None,
             device=None) -> Params:
    """The projections, drawn in the order w_dq, w_uq, w_dkv, w_uk, w_uv,
    wo; the latent RMS norm weights (ones) ``kv_norm`` and ``q_norm``."""
    d, h = cfg.d_model, cfg.n_heads
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt = policy.param_dtype

    def normal(shape):
        return normal_init(shape, 1.0, dt, generator, device)

    return {"w_dq": normal((d, r_q)), "w_uq": normal((r_q, h * (dn + dr))),
            "w_dkv": normal((d, r_kv + dr)), "w_uk": normal((r_kv, h * dn)),
            "w_uv": normal((r_kv, h * dv)), "wo": normal((h * dv, d)),
            "kv_norm": init_rms_norm(r_kv, dt, device),
            "q_norm": init_rms_norm(r_q, dt, device)}


def _mla_qkv(p, x, positions, cfg: ModelConfig):
    """(q_nope (B,S,H,dn), q_rope (B,S,H,dr) after RoPE, c_kv (B,S,r_kv)
    after its norm, k_rope (B,S,dr) after RoPE)."""
    b, s, _ = x.shape
    h, dn, r_kv = cfg.n_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    cq = rms_norm(x @ p.w_dq, p.q_norm)
    q = (cq @ p.w_uq).reshape(b, s, h, -1)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv_full = x @ p.w_dkv
    ckv = rms_norm(ckv_full[..., :r_kv], p.kv_norm)
    k_rope = apply_rope(ckv_full[..., None, r_kv:], positions, cfg.rope_theta)
    return q_nope, q_rope, ckv, k_rope[:, :, 0]


def _mla_heads_local(qf, ckv_full, positions, w_uk, w_uv, kv_norm, *,
                     cfg: ModelConfig, q_chunk, kv_chunk):
    """The MLA heads of one rank (all of them on one device), from the
    flat query projection ``qf`` (B, S, H*(dn+dr)) and the latent
    projection ``ckv_full`` (B, S, r_kv+dr): per-head K/V materialised
    from the latent, chunked attention with the [nope | rope] key and V
    zero-padded to the key width (one query group per head), V's width
    sliced after. Returns (out (B, S, H*dv), c_kv, k_rope)."""
    b, s, _ = qf.shape
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r_kv = cfg.kv_lora_rank
    q = qf.reshape(b, s, -1, dn + dr)
    h = q.shape[2]
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv = rms_norm(ckv_full[..., :r_kv], kv_norm)
    k_rope = apply_rope(ckv_full[..., None, r_kv:], positions,
                        cfg.rope_theta)[:, :, 0]
    k_nope = (ckv @ w_uk).reshape(b, s, h, dn)
    v = (ckv @ w_uv).reshape(b, s, h, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)],
                  dim=-1)
    vp = F.pad(v, (0, dn + dr - dv))
    out = chunked_attention(q[:, :, :, None, :], k, vp, causal=True,
                            q_chunk=q_chunk, kv_chunk=kv_chunk)
    out = out.reshape(b, s, h, dn + dr)[..., :dv]
    return out.reshape(b, s, h * dv), ckv, k_rope


def _mla_attend(p, x, positions, cfg: ModelConfig, q_chunk: int,
                kv_chunk: int):
    """The full-sequence MLA layer. Returns (y (B, S, D), c_kv, k_rope).
    On DTensors the heads run per rank (over ``model`` when it divides
    them), the latent whole on each."""
    x = shd.whole_seq(x)
    qf = rms_norm(x @ p.w_dq, p.q_norm) @ p.w_uq
    ckv_full = x @ p.w_dkv
    hd = shd.model_split(cfg.n_heads, qf)
    lat = (shd.DATA, None, None)
    out, ckv, k_rope = shd.local_call(
        functools.partial(_mla_heads_local, cfg=cfg, q_chunk=q_chunk,
                          kv_chunk=kv_chunk),
        (qf, ckv_full, positions, p.w_uk, p.w_uv, p.kv_norm),
        ((shd.DATA, None, hd), lat, (shd.DATA, None), (None, hd), (None, hd),
         (None,)),
        (((0, 0), None, (0, 2)), ((1, 0), None, None),
         ((1, 0), None, None)))
    return shd.constrain_residual(out @ p.wo), ckv, k_rope


def mla_forward(p, x, positions, cfg: ModelConfig, *, q_chunk: int = 256,
                kv_chunk: int = 512) -> torch.Tensor:
    return _mla_attend(p, x, positions, cfg, q_chunk, kv_chunk)[0]


def mla_prefill(p, x, positions, cfg: ModelConfig, cache_len: int, *,
                q_chunk: int = 256, kv_chunk: int = 512):
    """The forward output and the latent cache (c_kv (B, T, r_kv),
    k_rope (B, T, dr)), right-padded with zeros to ``cache_len``."""
    y, ckv, k_rope = _mla_attend(p, x, positions, cfg, q_chunk, kv_chunk)
    pad = (0, 0, 0, cache_len - x.shape[1])
    return y, (shd.pad(ckv, pad), shd.pad(k_rope, pad))


def mla_decode(p, x1, cache, length, cfg: ModelConfig):
    """Absorbed decode: the queries are mapped into the latent space
    (q_nope @ W_uk per head), so attention runs on the latent cache.
    x1 (B, 1, D); cache (c_kv (B, T, r_kv), k_rope (B, T, dr)); length
    (B,) each < T. Writes each row's new latent at its own ``length`` in
    place and attends positions <= length. Scores are rounded to the
    cache dtype before their sum and the widening, the probabilities
    are cast to it, as the JAX package's einsums do. On DTensors each
    rank writes and attends its own slots of the latent cache (slots
    over ``model``), every head, and the softmax is combined over
    ``model``."""
    c_cache, r_cache = cache
    qf = rms_norm(x1 @ p.w_dq, p.q_norm) @ p.w_uq
    ckv_full = x1 @ p.w_dkv
    t0, group = seq_shard(c_cache)
    row = (shd.DATA, None, None)
    lat = (shd.DATA, "model" if group is not None else None, None)
    out = shd.local_call(
        functools.partial(_mla_decode_local, cfg=cfg, t0=t0, group=group),
        (qf, ckv_full, c_cache, r_cache, length.long(), p.w_uk, p.w_uv,
         p.kv_norm),
        (row, row, lat, lat, (shd.DATA,), (None, None), (None, None),
         (None,)),
        (((0, 0), None, None),))
    return shd.constrain_residual(out @ p.wo), (c_cache, r_cache)


def _mla_decode_local(qf, ckv_full, c_cache, r_cache, pos, w_uk, w_uv,
                      kv_norm, *, cfg: ModelConfig, t0, group):
    """One absorbed decode step on one rank's latent slots ``[t0, t0 +
    T_local)`` (all of them, ``group`` None, on one device)."""
    b = qf.shape[0]
    h, r_kv = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q = qf.reshape(b, 1, h, -1)
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], pos[:, None], cfg.rope_theta)
    ckv_new = rms_norm(ckv_full[..., :r_kv], kv_norm)
    k_rope_new = apply_rope(ckv_full[..., None, r_kv:], pos[:, None],
                            cfg.rope_theta)[:, :, 0]
    _write_rows(c_cache, ckv_new[:, 0], pos, t0, group)
    _write_rows(r_cache, k_rope_new[:, 0], pos, t0, group)
    t = c_cache.shape[1]
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0],
                         w_uk.reshape(r_kv, h, dn))
    s_lat = torch.einsum("bhr,btr->bht", q_lat, c_cache)
    s_rope = torch.einsum("bhd,btd->bht", q_rope[:, 0], r_cache)
    scores = (s_lat + s_rope).float() * (1.0 / (dn + dr) ** 0.5)
    mask = torch.arange(t, device=c_cache.device)[None] + t0 <= pos[:, None]
    scores = torch.where(mask[:, None], scores, NEG_INF)
    if group is None:
        probs = torch.softmax(scores, dim=-1).to(c_cache.dtype)
        ctx = torch.einsum("bht,btr->bhr", probs, c_cache)    # latent ctx
    else:
        o, l_sum = split_softmax_combine(
            scores, lambda pr: torch.einsum("bht,btr->bhr", pr,
                                            c_cache.float()), group)
        ctx = (o / l_sum[..., None]).to(c_cache.dtype)
    out = torch.einsum("bhr,rhd->bhd", ctx, w_uv.reshape(r_kv, h, dv))
    return out.reshape(b, 1, h * dv)


class MLA(FrozenParams):
    def __init__(self, cfg: ModelConfig, policy: DTypePolicy = DTypePolicy(),
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(init_mla(cfg, policy, generator, device))

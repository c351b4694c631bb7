"""Model assembly for all architecture families.

The torch counterpart of the JAX package's ``models/transformer.py`` for

  dense  — uniform decoder layers (GQA with qk-norm or QKV bias, SwiGLU);
  vlm    — the dense backbone consuming stub patch embeddings as a prefix;
  audio  — encoder-only (bidirectional) dense layers over stub frame
           embeddings;
  moe    — DeepSeek-V2 (MLA attention, leading dense layers, then layers
           of shared and routed top-k experts) or Llama-4 (GQA, groups of
           a dense layer and a MoE layer, ``moe_every`` = 2);
  ssm    — RWKV-6 (time-mix + channel-mix), attention-free;
  hybrid — RecurrentGemma: groups of (RG-LRU, RG-LRU, local attention),
           then a tail of RG-LRU layers, each sub-layer with its own
           SwiGLU MLP.

API, as the JAX package's, with the parameters held by an :class:`LM`
module that also carries its config:

  init_model(cfg, policy, seed=, torch_device=, trainable=) -> LM
  forward(model, tokens | embeds, ...)             -> (logits (B,S,V), aux)
  loss_fn(model, batch)                            -> scalar (chunked CE)
  init_cache(cfg, batch, cache_len, policy, torch_device=) -> cache
  prefill(model, tokens, cache_len)                -> (last logits (B,V), cache, lengths)
  decode_step(model, token, cache, length)         -> (logits (B,V), cache)

Layers run as a Python loop. Submodules are named as the reference's
parameter tree: ``layers.{l}`` (dense, vlm, audio, ssm);
``groups.{i}.{dense,moe}``
(Llama-4) or ``dense_layers.{j}`` and ``moe_layers.{l}`` (DeepSeek-V2);
``groups.{i}.{rg1,rg2,attn}`` and ``tail.{j}`` (hybrid). Caches:

- dense and vlm: ``{"kv": [(k, v), ...]}``, one pair per layer, each
  ``(B, cache_len, KV, Dh)`` holding position p at slot p;
- moe: Llama-4 ``{"kv_dense": [...], "kv_moe": [...]}``, one (k, v)
  pair per group in each; DeepSeek-V2 ``{"latent_dense": [...],
  "latent": [...]}``, one latent pair ``(c_kv (B, cache_len, r_kv),
  k_rope (B, cache_len, dr))`` per dense and per MoE layer;
- ssm: a list with one dict per layer, ``{"tm_x": (B,D), "wkv":
  (B,H,Dh,Dh) float32, "cm_x": (B,D)}``;
- hybrid: ``{"groups": [{"rg1": st, "rg2": st, "kv": (k, v)}, ...],
  "tail": [st, ...]}`` with ``st = {"conv": (B,K-1,W), "h": (B,W)
  float32}`` and a ring-buffer window cache ``k, v (B,win,KV,Dh)`` that
  holds position p at slot ``p % win``;
- audio: none (encoder-only: ``init_cache`` and ``prefill`` raise
  ``ValueError``).

A model is built for serving, its parameters without grads, unless
``init_model(..., trainable=True)``. :func:`forward` and :func:`loss_fn`
build the autograd graph when grad is enabled and the model trains, and
run under ``inference_mode`` otherwise; ``prefill`` and ``decode_step``
always run under it. ``remat=True`` recomputes each layer of every
family in the backward (``torch.utils.checkpoint``, the JAX package's
``jax.checkpoint`` of its scan body): a dense, vlm, audio, ssm or MoE
layer (a MoE layer returns its load-balancing loss through the
checkpoint), a hybrid group or tail layer; and the loss recomputes each
chunk's logits. The hybrid's full-sequence pass builds no cache: its
local attention is ``gqa_forward`` with ``window=local_window``, as the
JAX package's ``forward``; ``prefill`` builds the ring-buffer cache.

:func:`forward` runs the experts with the capacity drops and returns
their summed load-balancing loss; ``prefill`` and ``decode_step`` run
them exact (nothing drops), as the JAX package's do.

:func:`decode_step` updates the ``wkv``, ``h``, KV and latent slabs in
place. The JAX package's sharding constraints do nothing on one device
and are left out. Entry points take ``torch_device``: ``None`` means cuda and raises
without a GPU; the CPU runs only when asked for.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig, hybrid_layout, require_ported
from repro_torch.distributed import sharding as shd
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rg_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.common import (
    DTypePolicy,
    frozen,
    init_rms_norm,
    normal_init,
    rms_norm,
)

Cache = Union[List[Dict[str, torch.Tensor]], Dict[str, Any]]

MOE_AUX_WEIGHT = 0.01
LOSS_CHUNK = 1024


class DenseLayer(nn.Module):
    """A decoder layer: norm, GQA, norm, MLP."""

    def __init__(self, cfg: ModelConfig, policy: DTypePolicy,
                 generator: Optional[torch.Generator], device):
        super().__init__()
        d, dt = cfg.d_model, policy.param_dtype
        self.ln1 = frozen(init_rms_norm(d, dt, device))
        self.attn = attn_mod.GQA(cfg, policy, generator, device)
        self.ln2 = frozen(init_rms_norm(d, dt, device))
        self.mlp = moe_mod.MLP(d, cfg.d_ff, policy, generator, device)


class RWKVLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, policy: DTypePolicy,
                 generator: Optional[torch.Generator], device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = frozen(init_rms_norm(d, policy.param_dtype, device))
        self.tm = rwkv_mod.TimeMix(cfg, policy, generator, device)
        self.ln2 = frozen(init_rms_norm(d, policy.param_dtype, device))
        self.cm = rwkv_mod.ChannelMix(cfg, policy, generator, device)


class RGLayer(nn.Module):
    """A recurrent sub-layer: norm, RG-LRU block, norm, MLP."""

    def __init__(self, cfg: ModelConfig, policy: DTypePolicy,
                 generator: Optional[torch.Generator], device):
        super().__init__()
        d, dt = cfg.d_model, policy.param_dtype
        self.ln1 = frozen(init_rms_norm(d, dt, device))
        self.block = rg_mod.RGBlock(cfg, policy, generator, device)
        self.ln2 = frozen(init_rms_norm(d, dt, device))
        self.mlp = moe_mod.MLP(d, cfg.d_ff, policy, generator, device)


class HybridGroup(nn.Module):
    """(rglru, rglru, local attention)."""

    def __init__(self, cfg: ModelConfig, policy: DTypePolicy,
                 generator: Optional[torch.Generator], device):
        super().__init__()
        self.rg1 = RGLayer(cfg, policy, generator, device)
        self.rg2 = RGLayer(cfg, policy, generator, device)
        self.attn = DenseLayer(cfg, policy, generator, device)


class MoELayer(nn.Module):
    """A MoE layer: norm, MLA (``use_mla``) or GQA, norm, experts."""

    def __init__(self, cfg: ModelConfig, policy: DTypePolicy,
                 generator: Optional[torch.Generator], device):
        super().__init__()
        d, dt = cfg.d_model, policy.param_dtype
        self.ln1 = frozen(init_rms_norm(d, dt, device))
        attn = attn_mod.MLA if cfg.use_mla else attn_mod.GQA
        self.attn = attn(cfg, policy, generator, device)
        self.ln2 = frozen(init_rms_norm(d, dt, device))
        self.moe = moe_mod.MoE(cfg, policy, generator, device)


class DeepseekDenseLayer(nn.Module):
    """DeepSeek-V2's leading dense layer: norm, MLA, norm, an MLP of
    ``dense_d_ff`` (or ``d_ff``)."""

    def __init__(self, cfg: ModelConfig, policy: DTypePolicy,
                 generator: Optional[torch.Generator], device):
        super().__init__()
        d, dt = cfg.d_model, policy.param_dtype
        self.ln1 = frozen(init_rms_norm(d, dt, device))
        self.attn = attn_mod.MLA(cfg, policy, generator, device)
        self.ln2 = frozen(init_rms_norm(d, dt, device))
        self.mlp = moe_mod.MLP(d, cfg.dense_d_ff or cfg.d_ff, policy,
                               generator, device)


class MoEGroup(nn.Module):
    """Llama-4's period: a dense layer, then a MoE layer."""

    def __init__(self, cfg: ModelConfig, policy: DTypePolicy,
                 generator: Optional[torch.Generator], device):
        super().__init__()
        self.dense = DenseLayer(cfg, policy, generator, device)
        self.moe = MoELayer(cfg, policy, generator, device)


class LM(nn.Module):
    """Embedding, the family's layers, final norm, LM head (``embed.T``
    when the embeddings are tied)."""

    def __init__(self, cfg: ModelConfig, policy: DTypePolicy = DTypePolicy(),
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        require_ported(cfg)
        self.cfg = cfg
        d, dt = cfg.d_model, policy.param_dtype
        self.embed = frozen(normal_init((cfg.vocab, d), 1.0, dt, generator,
                                         device))
        self.final_norm = frozen(init_rms_norm(d, dt, device))
        if not cfg.tie_embeddings:
            self.lm_head = frozen(normal_init((d, cfg.vocab), 1.0, dt,
                                               generator, device))
        if cfg.family in ("dense", "vlm", "audio", "ssm"):
            layer = RWKVLayer if cfg.family == "ssm" else DenseLayer
            self.layers = nn.ModuleList(
                layer(cfg, policy, generator, device)
                for _ in range(cfg.n_layers))
        elif cfg.family == "moe":
            n_moe, n_dense = cfg.moe_layout()
            if cfg.moe_every > 1:
                self.groups = nn.ModuleList(
                    MoEGroup(cfg, policy, generator, device)
                    for _ in range(n_moe))
            else:
                self.dense_layers = nn.ModuleList(
                    DeepseekDenseLayer(cfg, policy, generator, device)
                    for _ in range(n_dense))
                self.moe_layers = nn.ModuleList(
                    MoELayer(cfg, policy, generator, device)
                    for _ in range(n_moe))
        else:
            n_groups, tail = hybrid_layout(cfg)
            self.groups = nn.ModuleList(
                HybridGroup(cfg, policy, generator, device)
                for _ in range(n_groups))
            self.tail = nn.ModuleList(
                RGLayer(cfg, policy, generator, device)
                for _ in range(tail))


def init_model(cfg: ModelConfig, policy: DTypePolicy = DTypePolicy(), *,
               seed: int = 0, torch_device: DeviceLike = None,
               trainable: bool = False) -> LM:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on
    the target device (so a full-width model is drawn where it lives);
    the parameters take grads when ``trainable``. On ``meta`` the model
    has shapes and no data, and nothing is drawn (the counterpart of
    ``jax.eval_shape`` of the JAX package's ``init_model``)."""
    require_ported(cfg)
    dev = resolve_device(torch_device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        model = LM(cfg, policy, gen, dev)
    return model.requires_grad_(trainable)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _rwkv_block(layer: RWKVLayer, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[Dict[str, torch.Tensor]] = None):
    tm_state = None if state is None else (state["tm_x"], state["wkv"])
    cm_state = None if state is None else state["cm_x"]
    h = rms_norm(x, layer.ln1)
    y, (tm_x, wkv) = rwkv_mod.time_mix_forward(layer.tm, h, cfg, tm_state)
    x = x + y
    h = rms_norm(x, layer.ln2)
    y, cm_x = rwkv_mod.channel_mix_forward(layer.cm, h, cm_state)
    return x + y, {"tm_x": tm_x, "wkv": wkv, "cm_x": cm_x}


def _mlp_block(layer, x: torch.Tensor) -> torch.Tensor:
    """The second half of a dense layer or a hybrid sub-layer:
    x + MLP(norm(x))."""
    return x + moe_mod.mlp_forward(layer.mlp, rms_norm(x, layer.ln2))


def _moe_layers(model: LM):
    """The moe family's layers in run order, each with its cache's key:
    Llama-4's groups (dense, then MoE), or DeepSeek-V2's leading dense
    layers, then its MoE layers."""
    if model.cfg.moe_every > 1:
        for grp in model.groups:
            yield grp.dense, "kv_dense"
            yield grp.moe, "kv_moe"
    else:
        for layer in model.dense_layers:
            yield layer, "latent_dense"
        for layer in model.moe_layers:
            yield layer, "latent"


def _is_mla(layer) -> bool:
    return isinstance(layer.attn, attn_mod.MLA)


def _ffn_block(layer, x: torch.Tensor, cfg: ModelConfig,
               serving: bool = False) -> torch.Tensor:
    """x + FFN(norm(x)): the experts exact (prefill and decode, the
    latter ``serving``) in a MoE layer, else the MLP."""
    if isinstance(layer, MoELayer):
        return x + moe_mod.moe_forward(layer.moe, rms_norm(x, layer.ln2),
                                       cfg, exact=True, serving=serving)
    return _mlp_block(layer, x)


def _moe_block(layer, x: torch.Tensor, positions, cfg: ModelConfig):
    """One layer of the moe family's full-sequence pass, the experts with
    the capacity drops. Returns (x, the layer's load-balancing loss, or
    None for a dense layer)."""
    attend = attn_mod.mla_forward if _is_mla(layer) else \
        attn_mod.gqa_forward
    x = x + attend(layer.attn, rms_norm(x, layer.ln1), positions, cfg)
    if isinstance(layer, MoELayer):
        h = rms_norm(x, layer.ln2)
        aux = moe_mod.moe_aux_loss(layer.moe, h, cfg)
        return x + moe_mod.moe_forward(layer.moe, h, cfg), aux
    return _mlp_block(layer, x), None


def _moe_prefill(model: LM, tokens: torch.Tensor, cache_len: int):
    cfg = model.cfg
    x = _embed(model, tokens)
    positions = _positions(*x.shape[:2], x.device)
    cache: Dict[str, list] = {}
    for layer, key in _moe_layers(model):
        attend = attn_mod.mla_prefill if _is_mla(layer) else \
            attn_mod.gqa_prefill
        y, c = attend(layer.attn, rms_norm(x, layer.ln1), positions, cfg,
                      cache_len)
        x = _ffn_block(layer, x + y, cfg)
        cache.setdefault(key, []).append(c)
    return x, cache


def _moe_decode(model: LM, x: torch.Tensor, cache, length: torch.Tensor):
    cfg = model.cfg
    pending = {key: iter(slabs) for key, slabs in cache.items()}
    new_cache: Dict[str, list] = {}
    for layer, key in _moe_layers(model):
        attend = attn_mod.mla_decode if _is_mla(layer) else \
            attn_mod.gqa_decode
        y, c = attend(layer.attn, rms_norm(x, layer.ln1), next(pending[key]),
                      length, cfg)
        x = _ffn_block(layer, x + y, cfg, serving=True)
        new_cache.setdefault(key, []).append(c)
    return x, new_cache


def _rg_sub_block(layer: RGLayer, x: torch.Tensor, cfg: ModelConfig,
                  state=None):
    h = rms_norm(x, layer.ln1)
    y, new_state = rg_mod.rg_block_forward(layer.block, h, cfg, state)
    return _mlp_block(layer, x + y), new_state


def _rg_to_state(st) -> Dict[str, torch.Tensor]:
    conv, h = st
    return {"conv": conv, "h": h}


def _rg_decode(layer: RGLayer, x: torch.Tensor, cfg: ModelConfig,
               state: Dict[str, torch.Tensor]):
    """One step of a recurrent sub-layer; the state's ``h`` slab is
    updated in place."""
    y, st = _rg_sub_block(layer, x, cfg, (state["conv"], state["h"]))
    return y, _rg_to_state(st)


def _rg_layer(layer: RGLayer, x: torch.Tensor, cfg: ModelConfig):
    return _rg_sub_block(layer, x, cfg)[0]


def _hybrid_group(grp: HybridGroup, x: torch.Tensor, positions,
                  cfg: ModelConfig) -> torch.Tensor:
    """A hybrid group over the full sequence without a cache: two
    recurrent sub-layers, then the local attention over
    ``cfg.local_window`` and its MLP."""
    x = _rg_layer(grp.rg1, x, cfg)
    x = _rg_layer(grp.rg2, x, cfg)
    y = attn_mod.gqa_forward(grp.attn.attn, rms_norm(x, grp.attn.ln1),
                             positions, cfg, window=cfg.local_window)
    return _mlp_block(grp.attn, x + y)


def _windowed_prefill(p, x, positions, cfg: ModelConfig, win: int):
    """Sliding-window attention over the full sequence; returns the
    ring-buffer cache holding the last ``win`` positions (aligned so
    slot = pos mod win)."""
    y, k, v = attn_mod.attend(p, x, positions, cfg, window=win)
    whole = (shd.DATA, None, None, None)
    ck, cv = shd.local_call(
        functools.partial(_ring, win=win), (k, v, positions),
        (whole, whole, (shd.DATA, None)),
        (((0, 0), None, None, None), ((0, 0), None, None, None)))
    return y, (ck, cv)


def _ring(k, v, positions, win: int):
    """The last ``win`` K/V rows placed at slots (pos mod win)."""
    b = k.shape[0]
    slots = positions[:, -win:] % win
    bidx = torch.arange(b, device=k.device)[:, None]
    ck = k.new_zeros((b, win) + k.shape[2:])
    cv = v.new_zeros((b, win) + v.shape[2:])
    ck[bidx, slots] = k[:, -win:]
    cv[bidx, slots] = v[:, -win:]
    return ck, cv


def _hybrid_prefill(model: LM, tokens: torch.Tensor, win: int):
    """Embedding and the hybrid layers over the full sequence with an
    attention window of ``win``. Returns (x, cache). It embeds the tokens
    itself, so that no caller holds the (B, S, D) embedding through the
    layers."""
    cfg = model.cfg
    x = _embed(model, tokens)
    positions = _positions(*x.shape[:2], x.device)
    groups = []
    for grp in model.groups:
        x, rg1 = _rg_sub_block(grp.rg1, x, cfg)
        x, rg2 = _rg_sub_block(grp.rg2, x, cfg)
        y, kv = _windowed_prefill(grp.attn.attn, rms_norm(x, grp.attn.ln1),
                                  positions, cfg, win)
        x = _mlp_block(grp.attn, x + y)
        groups.append({"rg1": _rg_to_state(rg1), "rg2": _rg_to_state(rg2),
                       "kv": kv})
    tail = []
    for layer in model.tail:
        x, st = _rg_sub_block(layer, x, cfg)
        tail.append(_rg_to_state(st))
    return x, {"groups": groups, "tail": tail}


def _windowed_decode(p, x1, cache, length, cfg: ModelConfig):
    """Sliding-window decode with a ring-buffer cache of ``win`` slots:
    the new KV overwrites slot (length mod win) in place; attention masks
    the slots beyond min(length+1, win)."""
    return attn_mod.gqa_decode(p, x1, cache, length, cfg,
                               window=cache[0].shape[1])


def _embed(model: LM, tokens: Optional[torch.Tensor],
           embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The token embeddings, behind the ``embeds`` prefix when both are
    given (vlm), or ``embeds`` alone (audio). Embeddings are cast to the
    parameters' dtype: the JAX package casts a vlm prefix so and lets
    jnp's promotion widen audio frames at their first product. The
    lookup is ``F.embedding``, whose backward sums a row's gradients in
    a fixed order on the CPU too (an index's backward adds them in the
    order its threads arrive)."""
    if tokens is None:
        return shd.constrain_residual(embeds.to(model.embed.dtype))
    if not shd.is_dtensor(tokens):
        tokens = torch.as_tensor(tokens, device=model.embed.device)
    # under a policy the vocab-sharded lookup's partial rows are reduced
    # here, once, into the residual layout (a decode step's (B, D) rows
    # onto every rank, as its tokens are)
    x = F.embedding(tokens, model.embed)
    x = shd.constrain_residual(x) if x.dim() == 3 else \
        shd.constrain(x, (None, None))
    if embeds is not None:
        x = shd.constrain_residual(torch.cat([embeds.to(x.dtype), x], dim=1))
    return x


def _unembed(model: LM, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(shd.whole_seq(x), model.final_norm)
    head = (model.embed.T if model.cfg.tie_embeddings else model.lm_head)
    return x @ head


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _trains(model: LM) -> bool:
    return torch.is_grad_enabled() and any(p.requires_grad
                                           for p in model.parameters())


def _dense_block(layer: DenseLayer, x: torch.Tensor, positions,
                 cfg: ModelConfig) -> torch.Tensor:
    y = attn_mod.gqa_forward(layer.attn, rms_norm(x, layer.ln1), positions,
                             cfg, causal=not cfg.encoder_only)
    return _mlp_block(layer, x + y)


def _rwkv_layer(layer: RWKVLayer, x: torch.Tensor, cfg: ModelConfig):
    return _rwkv_block(layer, x, cfg)[0]


def _boundary(fn, *args):
    """``fn(*args)`` with its residual output (the first of a pair)
    constrained at the layer boundary (a no-op outside a policy)."""
    out = fn(*args)
    if isinstance(out, tuple):
        return (shd.constrain_residual(out[0]),) + out[1:]
    return shd.constrain_residual(out)


def _layer_call(remat: bool, fn, *args):
    """``fn(*args)``, recomputed in the backward when ``remat`` and grad
    is enabled, its output constrained at the layer boundary."""
    if remat and torch.is_grad_enabled():
        return checkpoint(_boundary, fn, *args, use_reentrant=False)
    return _boundary(fn, *args)


def forward(model: LM, tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            return_hidden: bool = False, remat: bool = False):
    """Full-sequence forward over ``tokens`` (B, S), the ``embeds``
    prefix (B, P, D) and ``tokens`` (vlm), or ``embeds`` alone (audio).
    Returns (logits (B, S, V), or the hidden states before the final
    norm when ``return_hidden``; aux_loss): the MoE layers' summed
    load-balancing loss (float32), 0 for the other families. It builds
    the autograd graph when grad is enabled and the model trains, with
    each layer (a hybrid group) recomputed in the backward when
    ``remat``."""
    cfg = model.cfg
    require_ported(cfg)
    with torch.inference_mode(not _trains(model)):
        x = _embed(model, tokens, embeds)
        positions = _positions(*x.shape[:2], x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family == "moe":
            for layer, _ in _moe_layers(model):
                x, a = _layer_call(remat, _moe_block, layer, x, positions,
                                   cfg)
                if a is not None:
                    aux = aux + a
        elif cfg.family in ("dense", "vlm", "audio"):
            for layer in model.layers:
                x = _layer_call(remat, _dense_block, layer, x, positions, cfg)
        elif cfg.family == "ssm":
            for layer in model.layers:
                x = _layer_call(remat, _rwkv_layer, layer, x, cfg)
        else:
            for grp in model.groups:
                x = _layer_call(remat, _hybrid_group, grp, x, positions, cfg)
            for layer in model.tail:
                x = _layer_call(remat, _rg_layer, layer, x, cfg)
        return (x if return_hidden else _unembed(model, x)), aux


def _chunk_loss(h, labels, norm_w, head):
    """The summed cross-entropy of one chunk's rows with label >= 0, and
    their count: the final norm and the logits of the chunk alone."""
    # under a policy the vocab-sharded logits are gathered per chunk
    logits = shd.constrain((rms_norm(h, norm_w) @ head).float(),
                           (shd.DATA, None, None))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def loss_fn(model: LM, batch: Dict[str, torch.Tensor],
            loss_chunk: int = LOSS_CHUNK, remat: bool = False):
    """Chunked cross-entropy, never holding the (B, S, V) logits.

    batch: {"tokens": (B, S) int, "labels": (B, S) int, optional
    "embeds": (B, P, D)}; labels already shifted, label -100 masked. The
    loss is taken on the text positions of a vlm batch. The sequence is
    padded to whole chunks of ``loss_chunk`` (labels -100); each chunk's
    final norm and logits are recomputed in the backward. Returns the
    mean over unmasked labels plus ``MOE_AUX_WEIGHT`` times the MoE
    load-balancing loss."""
    tokens, embeds = batch.get("tokens"), batch.get("embeds")
    with torch.inference_mode(not _trains(model)):
        hidden, aux = forward(model, tokens, embeds, return_hidden=True,
                              remat=remat)
        labels = torch.as_tensor(batch["labels"], device=hidden.device)
        hidden = shd.whole_seq(hidden)
        if embeds is not None and tokens is not None:
            hidden = hidden[:, embeds.shape[1]:]   # loss on text positions
        s = hidden.shape[1]
        chunk = min(loss_chunk, s)
        pad = (-s) % chunk
        if pad:
            hidden = shd.pad(hidden, (0, 0, 0, pad))
            labels = shd.pad(labels, (0, pad), value=-100)
        head = model.embed.T if model.cfg.tie_embeddings else model.lm_head
        sums, counts = [], []
        for c in range(hidden.shape[1] // chunk):
            args = (hidden[:, c * chunk:(c + 1) * chunk],
                    labels[:, c * chunk:(c + 1) * chunk].long(),
                    model.final_norm, head)
            if torch.is_grad_enabled():
                total, n = checkpoint(_chunk_loss, *args, use_reentrant=False)
            else:
                total, n = _chunk_loss(*args)
            sums.append(total)
            counts.append(n)
        ce = torch.stack(sums).sum() / torch.clamp(torch.stack(counts).sum(),
                                                   min=1.0)
        return ce + MOE_AUX_WEIGHT * aux


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               policy: DTypePolicy = DTypePolicy(), *,
               torch_device: DeviceLike = None) -> Cache:
    """Decode state for ``batch`` sequences. The dense and moe KV and
    latent caches have ``cache_len`` positions; RWKV-6's state is O(1)
    in the context, so ``cache_len`` sets no size there; the hybrid
    window cache has ``min(local_window, cache_len)`` slots."""
    require_ported(cfg)
    if cfg.encoder_only:
        raise ValueError("encoder-only architectures have no decode step")
    dev = resolve_device(torch_device)
    dt = policy.compute_dtype

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if cfg.family in ("dense", "vlm"):
        def kv():
            return zeros(batch, cache_len, cfg.n_kv_heads, cfg.d_head)

        return {"kv": [(kv(), kv()) for _ in range(cfg.n_layers)]}
    if cfg.family == "moe":
        n_moe, n_dense = cfg.moe_layout()
        if cfg.moe_every > 1:
            def kv():
                return zeros(batch, cache_len, cfg.n_kv_heads, cfg.d_head)

            return {"kv_dense": [(kv(), kv()) for _ in range(n_moe)],
                    "kv_moe": [(kv(), kv()) for _ in range(n_moe)]}

        def lat():
            return (zeros(batch, cache_len, cfg.kv_lora_rank),
                    zeros(batch, cache_len, cfg.qk_rope_head_dim))

        return {"latent_dense": [lat() for _ in range(n_dense)],
                "latent": [lat() for _ in range(n_moe)]}
    if cfg.family == "ssm":
        h, dh = rwkv_mod.n_heads(cfg), rwkv_mod.HEAD_DIM
        return [{"tm_x": zeros(batch, cfg.d_model),
                 "wkv": zeros(batch, h, dh, dh, dtype=torch.float32),
                 "cm_x": zeros(batch, cfg.d_model)}
                for _ in range(cfg.n_layers)]
    w = cfg.rg_lru_width or cfg.d_model
    n_groups, tail = hybrid_layout(cfg)
    win = min(cfg.local_window, cache_len)

    def rg_state():
        return {"conv": zeros(batch, cfg.rg_conv_width - 1, w),
                "h": zeros(batch, w, dtype=torch.float32)}

    def kv():
        return zeros(batch, win, cfg.n_kv_heads, cfg.d_head)

    return {"groups": [{"rg1": rg_state(), "rg2": rg_state(),
                        "kv": (kv(), kv())} for _ in range(n_groups)],
            "tail": [rg_state() for _ in range(tail)]}


@torch.inference_mode()
def prefill(model: LM, tokens: torch.Tensor, cache_len: int):
    """Run the full prompt, build the decode cache. Returns
    (last-position logits (B, V), cache, lengths (B,) int32). The hybrid
    window is ``min(local_window, cache_len)``. A vlm prefills its token
    stream alone (no image prefix), as the JAX package does."""
    cfg = model.cfg
    require_ported(cfg)
    if cfg.encoder_only:
        raise ValueError("encoder-only architectures have no decode step")
    b, s = tokens.shape[:2]
    if cfg.family == "moe":
        x, cache = _moe_prefill(model, tokens, cache_len)
    elif cfg.family in ("dense", "vlm"):
        x = _embed(model, tokens)
        positions = _positions(b, s, x.device)
        kvs = []
        for layer in model.layers:
            y, kv = attn_mod.gqa_prefill(layer.attn, rms_norm(x, layer.ln1),
                                         positions, cfg, cache_len)
            x = _mlp_block(layer, x + y)
            kvs.append(kv)
        cache: Cache = {"kv": kvs}
    elif cfg.family == "ssm":
        x = _embed(model, tokens)
        cache = []
        for layer in model.layers:
            x, st = _rwkv_block(layer, x, cfg)
            cache.append(st)
    else:
        x, cache = _hybrid_prefill(model, tokens,
                                   min(cfg.local_window, cache_len))
    logits = _unembed(model, shd.whole_seq(x)[:, -1:])[:, 0]
    lengths = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return logits, cache, lengths


@torch.inference_mode()
def decode_step(model: LM, token: torch.Tensor, cache: Cache,
                length: torch.Tensor):
    """token: (B,) int; length: (B,) current context lengths (the
    position of ``token``; RWKV-6 needs none). Returns (logits (B, V),
    cache); the cache's state and KV slabs are updated in place."""
    cfg = model.cfg
    require_ported(cfg)
    if cfg.encoder_only:
        raise ValueError("encoder-only architectures have no decode step")
    x = _embed(model, token)[:, None]                  # (B, 1, D)
    if cfg.family == "moe":
        x, new_cache = _moe_decode(model, x, cache, length)
    elif cfg.family in ("dense", "vlm"):
        kvs = []
        for layer, kv in zip(model.layers, cache["kv"]):
            y, kv = attn_mod.gqa_decode(layer.attn, rms_norm(x, layer.ln1),
                                        kv, length, cfg)
            x = _mlp_block(layer, x + y)
            kvs.append(kv)
        new_cache: Cache = {"kv": kvs}
    elif cfg.family == "ssm":
        new_cache = []
        for layer, st in zip(model.layers, cache):
            x, st = _rwkv_block(layer, x, cfg, st)
            new_cache.append(st)
    else:
        groups = []
        for grp, st in zip(model.groups, cache["groups"]):
            x, rg1 = _rg_decode(grp.rg1, x, cfg, st["rg1"])
            x, rg2 = _rg_decode(grp.rg2, x, cfg, st["rg2"])
            y, kv = _windowed_decode(grp.attn.attn,
                                     rms_norm(x, grp.attn.ln1), st["kv"],
                                     length, cfg)
            x = _mlp_block(grp.attn, x + y)
            groups.append({"rg1": rg1, "rg2": rg2, "kv": kv})
        tail = []
        for layer, st in zip(model.tail, cache["tail"]):
            x, st = _rg_decode(layer, x, cfg, st)
            tail.append(st)
        new_cache = {"groups": groups, "tail": tail}
    logits = _unembed(model, x)[:, 0]
    return logits, new_cache

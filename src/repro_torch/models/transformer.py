"""Model assembly: the ``ssm`` family (RWKV-6), the one the port serves.

The torch counterpart of the JAX package's ``models/transformer.py`` for
attention-free RWKV-6 (time-mix + channel-mix layers). The other
families (dense, vlm, audio, moe, hybrid) raise ``NotImplementedError``
until their slice of the port lands (ROADMAP, queue 1, item 12).

API, as the JAX package's, with the parameters held by an :class:`LM`
module that also carries its config:

  init_model(cfg, policy, seed=, torch_device=)    -> LM
  forward(model, tokens)                           -> (logits (B,S,V), aux)
  init_cache(cfg, batch, cache_len, policy, torch_device=) -> cache
  prefill(model, tokens, cache_len)                -> (last logits (B,V), cache, lengths)
  decode_step(model, token, cache, length)         -> (logits (B,V), cache)

Layers run as a Python loop. A cache is a list with one dict per layer,
``{"tm_x": (B,D), "wkv": (B,H,Dh,Dh) float32, "cm_x": (B,D)}``;
:func:`decode_step` updates each ``wkv`` slab in place. The JAX
package's sharding constraints do nothing on one device and are left
out. Entry points take ``torch_device``: ``None`` means cuda and raises
without a GPU; the CPU runs only when asked for.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.common import (
    DTypePolicy,
    frozen,
    init_rms_norm,
    normal_init,
    rms_norm,
)

Cache = List[Dict[str, torch.Tensor]]


def _require_ssm(cfg: ModelConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to "
            "repro_torch yet (ROADMAP, queue 1, item 12); only 'ssm' "
            "(RWKV-6) is")


class RWKVLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, policy: DTypePolicy,
                 generator: Optional[torch.Generator], device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = frozen(init_rms_norm(d, policy.param_dtype, device))
        self.tm = rwkv_mod.TimeMix(cfg, policy, generator, device)
        self.ln2 = frozen(init_rms_norm(d, policy.param_dtype, device))
        self.cm = rwkv_mod.ChannelMix(cfg, policy, generator, device)


class LM(nn.Module):
    """Embedding, ``cfg.n_layers`` RWKV-6 layers, final norm, LM head."""

    def __init__(self, cfg: ModelConfig, policy: DTypePolicy = DTypePolicy(),
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        _require_ssm(cfg)
        self.cfg = cfg
        d, dt = cfg.d_model, policy.param_dtype
        self.embed = frozen(normal_init((cfg.vocab, d), 1.0, dt, generator,
                                         device))
        self.final_norm = frozen(init_rms_norm(d, dt, device))
        if not cfg.tie_embeddings:
            self.lm_head = frozen(normal_init((d, cfg.vocab), 1.0, dt,
                                               generator, device))
        self.layers = nn.ModuleList(
            RWKVLayer(cfg, policy, generator, device)
            for _ in range(cfg.n_layers))


def init_model(cfg: ModelConfig, policy: DTypePolicy = DTypePolicy(), *,
               seed: int = 0, torch_device: DeviceLike = None) -> LM:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on
    the target device (so a full-width model is drawn where it lives)."""
    _require_ssm(cfg)
    dev = resolve_device(torch_device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        return LM(cfg, policy, gen, dev)


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


def _embed(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    return model.embed[torch.as_tensor(tokens, device=model.embed.device)]


def _unembed(model: LM, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, model.final_norm)
    head = (model.embed.T if model.cfg.tie_embeddings else model.lm_head)
    return x @ head


@torch.inference_mode()
def forward(model: LM, tokens: torch.Tensor):
    """Full-sequence forward. Returns (logits (B,S,V), aux_loss = 0)."""
    cfg = model.cfg
    _require_ssm(cfg)
    x = _embed(model, tokens)
    for layer in model.layers:
        x, _ = _rwkv_block(layer, x, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _unembed(model, x), aux


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               policy: DTypePolicy = DTypePolicy(), *,
               torch_device: DeviceLike = None) -> Cache:
    """Decode state for ``batch`` sequences. RWKV-6's state is O(1) in the
    context, so ``cache_len`` sets no size."""
    _require_ssm(cfg)
    dev = resolve_device(torch_device)
    h, dh, dt = rwkv_mod.n_heads(cfg), rwkv_mod.HEAD_DIM, policy.compute_dtype
    return [{"tm_x": torch.zeros((batch, cfg.d_model), dtype=dt, device=dev),
             "wkv": torch.zeros((batch, h, dh, dh), dtype=torch.float32,
                                device=dev),
             "cm_x": torch.zeros((batch, cfg.d_model), dtype=dt, device=dev)}
            for _ in range(cfg.n_layers)]


@torch.inference_mode()
def prefill(model: LM, tokens: torch.Tensor, cache_len: int):
    """Run the full prompt, build the decode cache. Returns
    (last-position logits (B, V), cache, lengths (B,) int32).
    ``cache_len`` sets no size (see :func:`init_cache`)."""
    cfg = model.cfg
    _require_ssm(cfg)
    x = _embed(model, tokens)
    b, s = x.shape[:2]
    cache: Cache = []
    for layer in model.layers:
        x, st = _rwkv_block(layer, x, cfg)
        cache.append(st)
    logits = _unembed(model, x[:, -1:])[:, 0]
    lengths = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return logits, cache, lengths


@torch.inference_mode()
def decode_step(model: LM, token: torch.Tensor, cache: Cache,
                length: torch.Tensor):
    """token: (B,) int; length: (B,) current context lengths (RWKV-6
    needs none). Returns (logits (B, V), cache); the cache's wkv slabs
    are updated in place."""
    cfg = model.cfg
    _require_ssm(cfg)
    x = _embed(model, token)[:, None]                  # (B, 1, D)
    new_cache: Cache = []
    for layer, st in zip(model.layers, cache):
        x, st = _rwkv_block(layer, x, cfg, st)
        new_cache.append(st)
    logits = _unembed(model, x)[:, 0]
    return logits, new_cache

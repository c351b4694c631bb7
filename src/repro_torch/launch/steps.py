"""Step functions: train_step, eval_step, prefill_step and serve_step.

The JAX package's ``launch/steps.py`` builders on one device: the step
bodies without shardings to build.

- ``train_step``: the loss and its gradients (``loss_fn``, each layer
  recomputed in the backward when ``remat``), then one AdamW update of
  the model's parameters in place;
- ``eval_step``: the encoder forward (the audio family's prefill cells);
- ``prefill_step``: the prompt pass that builds the decode cache; a vlm
  prefills its token stream alone, as the JAX package does;
- ``serve_step``: one decode step against the cache, then greedy argmax
  (ties go to the first index).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.transformer import (
    LM,
    Cache,
    decode_step,
    forward,
    loss_fn,
    prefill,
)
from repro_torch.optim import adamw


def train_step(model: LM, opt_state: adamw.AdamWState,
               batch: Dict[str, torch.Tensor],
               opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
               remat: bool = True):
    """One step of a model built with ``trainable=True``. Returns
    (opt_state, metrics {"loss", "grad_norm", "lr"}, 0-d tensors); the
    parameters are updated in place. A parameter the loss does not reach
    (an untied audio model's token embedding) gets a zero gradient, as
    ``jax.grad`` gives it."""
    params = dict(model.named_parameters())
    if not all(p.requires_grad for p in params.values()):
        raise ValueError("train_step needs a model built with "
                         "init_model(..., trainable=True)")
    with torch.enable_grad():
        loss = loss_fn(model, batch, remat=remat)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
    grads = {name: torch.zeros_like(p) if g is None else g
             for (name, p), g in zip(params.items(), grads)}
    _, opt_state, metrics = adamw.apply_updates(params, grads, opt_state,
                                                opt_cfg)
    metrics["loss"] = loss.detach()
    return opt_state, metrics


@torch.inference_mode()
def eval_step(model: LM, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The logits (B, S, V) of ``batch``'s tokens and/or embeddings,
    without a graph even when the model trains."""
    return forward(model, batch.get("tokens"), batch.get("embeds"))[0]


def prefill_step(model: LM, batch: Dict[str, torch.Tensor], cache_len: int):
    """(last-position logits (B, V), cache, lengths) of the prompt
    ``batch["tokens"]``."""
    return prefill(model, batch["tokens"], cache_len)


@torch.inference_mode()
def serve_step(model: LM, cache: Cache, token: torch.Tensor,
               length: torch.Tensor):
    """Returns (next_token (B,) int32, logits (B, V), cache, length+1)."""
    logits, cache = decode_step(model, token, cache, length)
    next_token = torch.argmax(logits, dim=-1).to(torch.int32)
    return next_token, logits, cache, length + 1

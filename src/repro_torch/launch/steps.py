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

The builders (``build_train_step``, ``build_eval_step``,
``build_prefill_step``, ``build_serve_step`` and ``build_cell``) are the
JAX package's: each returns one of these steps with a function that
gives its arguments for a shape cell, as tensors on ``meta`` (shapes
without data, the counterpart of ``jax.eval_shape``'s
``ShapeDtypeStruct``s; ``model_shape_specs`` and ``opt_shape_specs``),
and the in and out shardings, which are None: one card places nothing.
A mesh of two or more devices is refused (``launch/mesh.py``).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeCell
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch.mesh import Mesh, mesh_device
from repro_torch.models.common import DTypePolicy
from repro_torch.models.transformer import (
    LM,
    Cache,
    decode_step,
    forward,
    init_cache,
    init_model,
    loss_fn,
    prefill,
)
from repro_torch.optim import adamw

BF16 = DTypePolicy.bf16()
META = torch.device("meta")


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


# ---------------------------------------------------------------------------
# Builders: a step and its arguments as shapes on ``meta``
# ---------------------------------------------------------------------------


def model_shape_specs(cfg: ModelConfig, policy: DTypePolicy = BF16,
                      trainable: bool = False) -> LM:
    """The model on ``meta``: every parameter's shape and dtype, no
    data."""
    return init_model(cfg, policy, torch_device=META, trainable=trainable)


def opt_shape_specs(model: LM, opt_cfg: adamw.AdamWConfig
                    ) -> adamw.AdamWState:
    """AdamW's state for ``model``'s parameters, on their device."""
    return adamw.init(dict(model.named_parameters()), opt_cfg)


def _batch(cfg: ModelConfig, shape: ShapeCell, labels: bool):
    return {k: torch.empty(s, dtype=dt, device=META)
            for k, (s, dt) in make_batch_specs(cfg, shape).items()
            if labels or k != "labels"}


def build_train_step(cfg: ModelConfig, mesh: Optional[Mesh] = None,
                     opt_cfg: Optional[adamw.AdamWConfig] = None,
                     policy: DTypePolicy = BF16, remat: bool = True):
    """Returns (train_step with ``opt_cfg`` and ``remat`` bound,
    input_specs): ``input_specs(shape)`` gives ((model, opt_state,
    batch), in_shardings, out_shardings)."""
    mesh_device(mesh)
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def input_specs(shape: ShapeCell):
        model = model_shape_specs(cfg, policy, trainable=True)
        args = (model, opt_shape_specs(model, opt_cfg),
                _batch(cfg, shape, labels=True))
        return args, None, None

    return functools.partial(train_step, opt_cfg=opt_cfg,
                             remat=remat), input_specs


def build_eval_step(cfg: ModelConfig, mesh: Optional[Mesh] = None,
                    policy: DTypePolicy = BF16):
    """Returns (eval_step, input_specs): ``(model, batch)`` without
    labels."""
    mesh_device(mesh)

    def input_specs(shape: ShapeCell):
        return (model_shape_specs(cfg, policy),
                _batch(cfg, shape, labels=False)), None, None

    return eval_step, input_specs


def build_prefill_step(cfg: ModelConfig, mesh: Optional[Mesh] = None,
                       policy: DTypePolicy = BF16):
    """Returns (prefill_step, input_specs): ``(model, batch)``; the
    cache length is the static ``cache_len``."""
    mesh_device(mesh)

    def input_specs(shape: ShapeCell):
        return (model_shape_specs(cfg, policy),
                _batch(cfg, shape, labels=False)), None, None

    return prefill_step, input_specs


def build_serve_step(cfg: ModelConfig, mesh: Optional[Mesh] = None,
                     policy: DTypePolicy = BF16):
    """Returns (serve_step, input_specs): ``(model, cache of
    shape.seq_len positions, token (B,) int32, length (B,) int32)``."""
    mesh_device(mesh)

    def input_specs(shape: ShapeCell):
        b = shape.global_batch
        cache = init_cache(cfg, b, shape.seq_len, policy, torch_device=META)
        ints = torch.empty((b,), dtype=torch.int32, device=META)
        return (model_shape_specs(cfg, policy), cache, ints,
                torch.empty_like(ints)), None, None

    return serve_step, input_specs


def build_cell(cfg: ModelConfig, shape: ShapeCell,
               mesh: Optional[Mesh] = None, policy: DTypePolicy = BF16):
    """Returns (fn, args on meta, in_shardings, out_shardings,
    static_kwargs) of the step a (cfg, shape) cell runs: train, the
    encoder's eval step or the prefill for ``prefill`` cells, the serve
    step for ``decode`` cells."""
    if shape.kind == "train":
        fn, ispec = build_train_step(cfg, mesh, policy=policy)
        args, in_sh, out_sh = ispec(shape)
        return fn, args, in_sh, out_sh, {}
    if shape.kind == "prefill":
        if cfg.encoder_only:
            fn, ispec = build_eval_step(cfg, mesh, policy=policy)
            args, in_sh, out_sh = ispec(shape)
            return fn, args, in_sh, out_sh, {}
        fn, ispec = build_prefill_step(cfg, mesh, policy=policy)
        args, in_sh, out_sh = ispec(shape)
        return fn, args, in_sh, out_sh, {"cache_len": shape.seq_len}
    if shape.kind == "decode":
        fn, ispec = build_serve_step(cfg, mesh, policy=policy)
        args, in_sh, out_sh = ispec(shape)
        return fn, args, in_sh, out_sh, {}
    raise ValueError(shape.kind)

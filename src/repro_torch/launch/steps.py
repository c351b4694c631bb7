"""Step functions: train_step, eval_step, prefill_step and serve_step.

The JAX package's ``launch/steps.py``:

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
JAX package's: each returns a step with a function that gives its
arguments for a shape cell, as tensors on ``meta`` (shapes without data,
the counterpart of ``jax.eval_shape``'s ``ShapeDtypeStruct``s;
``model_shape_specs`` and ``opt_shape_specs``), and the in and out
placements.

On a ``DeviceMesh`` (``launch/mesh.py``) the built step places its
arguments as DTensors before it runs, each by the JAX package's rules
(``distributed/sharding.py``): the parameters by ``param_specs``
(serving: ``param_specs_serving``), AdamW's moments as their
parameters, the batch by ``batch_specs`` and the caches by
``cache_specs``; serve tokens and lengths are replicated. A parameter
or moment already placed stays where it is, so the model is placed once
(in place) and later steps move nothing. The step runs under the
activation policy; the gradients are redistributed to their
parameters' placements before AdamW (a partial sum is reduced there),
and the prefill's cache is redistributed to ``cache_specs``. The
returned metrics and logits are whole tensors on every rank. Without a
mesh, or on the one-device mesh of a run without a process group, the
steps run as they always have, and their placements are None.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeCell
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import is_device_mesh
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
    # pin the gradients to the parameters' layout before the optimizer's
    # arithmetic: a DTensor gradient may come back as a partial sum
    grads = {name: g.redistribute(params[name].device_mesh,
                                  params[name].placements)
             if shd.is_dtensor(g) else g for name, g in grads.items()}
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
    # under a policy the vocab-sharded logits are gathered for the argmax
    logits = shd.constrain(logits, (shd.DATA, None))
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


# ---------------------------------------------------------------------------
# Placement on a DeviceMesh
# ---------------------------------------------------------------------------


def _placements(specs: Dict[str, tuple], mesh) -> Dict[str, tuple]:
    """{name: placements} of {name: spec}."""
    return {k: shd.placements(v, mesh) for k, v in specs.items()}


def place_model(model: LM, mesh, serving: bool = False) -> LM:
    """``model``'s parameters placed in place on ``mesh`` by
    ``param_specs`` (``param_specs_serving`` when ``serving``), once:
    a model this function last placed so is returned as it is."""
    if getattr(model, "_placed_as", None) == (mesh, serving):
        return model
    rules = shd.param_specs_serving if serving else shd.param_specs
    shd.distribute_model(model, rules(model, mesh), mesh)
    model._placed_as = (mesh, serving)
    return model


def place_opt_state(state: adamw.AdamWState, model: LM, mesh
                    ) -> adamw.AdamWState:
    """AdamW's moments placed as their parameters (ZeRO-1), the step
    counter kept as it is (the same on every rank)."""
    params = dict(model.named_parameters())

    def like(moments):
        return {k: shd.place(m, None, mesh, like=params[k])
                for k, m in moments.items()}

    return adamw.AdamWState(state.step, like(state.mu), like(state.nu))


def _replicated(t: torch.Tensor, mesh):
    return shd.place(t, shd.replicated(t.dim()), mesh)


def _whole(tree):
    """Every DTensor of a dict of metrics or a tuple of outputs as its
    whole tensor."""
    if isinstance(tree, dict):
        return {k: shd.full(v) for k, v in tree.items()}
    return shd.full(tree)


def build_train_step(cfg: ModelConfig, mesh=None,
                     opt_cfg: Optional[adamw.AdamWConfig] = None,
                     policy: DTypePolicy = BF16, remat: bool = True):
    """Returns (train_step with ``opt_cfg`` and ``remat`` bound,
    input_specs): ``input_specs(shape)`` gives ((model, opt_state,
    batch), in_placements, out_placements)."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    step = functools.partial(train_step, opt_cfg=opt_cfg, remat=remat)

    def input_specs(shape: ShapeCell):
        model = model_shape_specs(cfg, policy, trainable=True)
        args = (model, opt_shape_specs(model, opt_cfg),
                _batch(cfg, shape, labels=True))
        if not is_device_mesh(mesh):
            return args, None, None
        pl = _placements(shd.param_specs(model, mesh), mesh)
        opl = adamw.AdamWState((), pl, pl)
        bpl = _placements(shd.batch_specs(args[2], mesh), mesh)
        return args, (pl, opl, bpl), (pl, opl, None)

    if not is_device_mesh(mesh):
        return step, input_specs

    def sharded_step(model: LM, opt_state: adamw.AdamWState,
                     batch: Dict[str, torch.Tensor]):
        place_model(model, mesh)
        opt_state = place_opt_state(opt_state, model, mesh)
        batch = shd.distribute(batch, shd.batch_specs(batch, mesh), mesh)
        with shd.activation_policy(mesh):
            opt_state, metrics = step(model, opt_state, batch)
        return opt_state, _whole(metrics)

    return sharded_step, input_specs


def build_eval_step(cfg: ModelConfig, mesh=None,
                    policy: DTypePolicy = BF16):
    """Returns (eval_step, input_specs): ``(model, batch)`` without
    labels."""
    def input_specs(shape: ShapeCell):
        args = (model_shape_specs(cfg, policy),
                _batch(cfg, shape, labels=False))
        if not is_device_mesh(mesh):
            return args, None, None
        return args, (_placements(shd.param_specs(args[0], mesh), mesh),
                      _placements(shd.batch_specs(args[1], mesh), mesh)), \
            None

    if not is_device_mesh(mesh):
        return eval_step, input_specs

    def sharded_step(model: LM, batch: Dict[str, torch.Tensor]):
        place_model(model, mesh)
        batch = shd.distribute(batch, shd.batch_specs(batch, mesh), mesh)
        with shd.activation_policy(mesh):
            return eval_step(model, batch)

    return sharded_step, input_specs


def build_prefill_step(cfg: ModelConfig, mesh=None,
                       policy: DTypePolicy = BF16):
    """Returns (prefill_step, input_specs): ``(model, batch)``; the
    cache length is the static ``cache_len``."""
    def input_specs(shape: ShapeCell):
        args = (model_shape_specs(cfg, policy),
                _batch(cfg, shape, labels=False))
        if not is_device_mesh(mesh):
            return args, None, None
        cache = init_cache(cfg, shape.global_batch, shape.seq_len, policy,
                           torch_device=META)
        return args, (_placements(shd.param_specs(args[0], mesh), mesh),
                      _placements(shd.batch_specs(args[1], mesh), mesh)), \
            (None, shd.cache_placements(cache, mesh), None)

    if not is_device_mesh(mesh):
        return prefill_step, input_specs

    def sharded_step(model: LM, batch: Dict[str, torch.Tensor],
                     cache_len: int):
        place_model(model, mesh)
        batch = shd.distribute(batch, shd.batch_specs(batch, mesh), mesh)
        with shd.activation_policy(mesh):
            logits, cache, lengths = prefill_step(model, batch, cache_len)
            cache = shd.distribute(cache, shd.cache_specs(cache, mesh), mesh)
        return shd.full(logits), cache, shd.full(lengths)

    return sharded_step, input_specs


def build_serve_step(cfg: ModelConfig, mesh=None,
                     policy: DTypePolicy = BF16):
    """Returns (serve_step, input_specs): ``(model, cache of
    shape.seq_len positions, token (B,) int32, length (B,) int32)``."""
    def input_specs(shape: ShapeCell):
        b = shape.global_batch
        cache = init_cache(cfg, b, shape.seq_len, policy, torch_device=META)
        ints = torch.empty((b,), dtype=torch.int32, device=META)
        args = (model_shape_specs(cfg, policy), cache, ints,
                torch.empty_like(ints))
        if not is_device_mesh(mesh):
            return args, None, None
        rep = shd.placements((None,), mesh)
        cpl = shd.cache_placements(cache, mesh)
        return args, (_placements(shd.param_specs_serving(args[0], mesh),
                                  mesh), cpl, rep, rep), (rep, None, cpl, rep)

    if not is_device_mesh(mesh):
        return serve_step, input_specs

    def sharded_step(model: LM, cache: Cache, token: torch.Tensor,
                     length: torch.Tensor):
        place_model(model, mesh, serving=True)
        cache = shd.distribute(cache, shd.cache_specs(cache, mesh), mesh)
        token, length = _replicated(token, mesh), _replicated(length, mesh)
        with shd.activation_policy(mesh, shard_residual_seq=False):
            nxt, logits, cache, length = serve_step(model, cache, token,
                                                    length)
        return shd.full(nxt), shd.full(logits), cache, shd.full(length)

    return sharded_step, input_specs


def build_cell(cfg: ModelConfig, shape: ShapeCell, mesh=None,
               policy: DTypePolicy = BF16):
    """Returns (fn, args on meta, in_placements, out_placements,
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

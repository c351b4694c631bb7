"""AdamW with warmup-cosine schedule and global-norm clipping.

The counterpart of the JAX package's ``optim/adamw.py``: plain functions
on dicts of tensors named as the model's ``named_parameters()``, not
``torch.optim.AdamW`` (whose schedule, clipping and decay mask differ).
The moments are dicts under the same names.

Decoupled weight decay falls on the leaves the JAX package decays,
those of rank 2 or more *in its parameter tree*. That tree stacks each
per-layer leaf on a leading layer axis, so a layer's norm weight, (D,)
here, is (L, D) there and decays; the final norm, (D,) in both, does
not. :func:`reference_ndim` gives that rank from the port's name.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Tuple

import torch

Tensors = Dict[str, torch.Tensor]

# the model's per-layer module lists: the JAX package stacks their leaves
STACKED = ("layers", "groups", "tail", "dense_layers", "moe_layers")


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: torch.dtype = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor     # () int32
    mu: Tensors            # first moments (params-like)
    nu: Tensors            # second moments (params-like)


def reference_ndim(name: str, p: torch.Tensor) -> int:
    """The rank of parameter ``name`` in the JAX package's tree: one more
    than ``p``'s under a per-layer list (``layers.3.ln1`` is a row of the
    stacked (L, D) leaf ``layers/ln1``)."""
    return p.dim() + (name.split(".", 1)[0] in STACKED)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to lr_min, in float32 as the JAX
    package computes it from its int32 step."""
    f = step.to(torch.float32)
    warm = cfg.lr_peak * (f + 1) / max(cfg.warmup_steps, 1)
    t = torch.clamp((f - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: Tensors, cfg: AdamWConfig = AdamWConfig()) -> AdamWState:
    """Zero moments and step 0, on the parameters' device."""
    def zeros():
        return {k: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                               device=p.device) for k, p in params.items()}

    dev = next(iter(params.values())).device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      zeros(), zeros())


def global_norm(tree: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


def clip_by_global_norm(grads: Tensors,
                        max_norm: float) -> Tuple[Tensors, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: (g.float() * scale).to(g.dtype)
            for k, g in grads.items()}, norm


@torch.no_grad()
def apply_updates(params: Tensors, grads: Tensors, state: AdamWState,
                  cfg: AdamWConfig = AdamWConfig()):
    """One AdamW step. The parameters and moments are updated in place
    (the model's own tensors, so the optimizer holds no second copy) and
    returned as (params, new state, metrics {"grad_norm", "lr"})."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    t = (step + 1).to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    for name, p in params.items():
        g32 = grads[name].float()
        m = b1 * state.mu[name].float() + (1 - b1) * g32
        v = b2 * state.nu[name].float() + (1 - b2) * torch.square(g32)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if reference_ndim(name, p) >= 2:   # decoupled decay on matrices
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        state.mu[name].copy_(m)
        state.nu[name].copy_(v)
    new_state = AdamWState(step + 1, state.mu, state.nu)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}

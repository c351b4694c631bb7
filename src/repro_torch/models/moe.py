"""Feed-forward layers: the dense SwiGLU MLP.

The torch counterpart of the dense half of the JAX package's
``models/moe.py``; the experts come with the slice that serves a
mixture-of-experts architecture.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import DTypePolicy, FrozenParams, normal_init

Params = Dict[str, torch.Tensor]


def init_mlp(d_model: int, d_ff: int, policy: DTypePolicy,
             generator: Optional[torch.Generator] = None,
             device=None) -> Params:
    dt = policy.param_dtype
    return {
        "w_gate": normal_init((d_model, d_ff), 1.0, dt, generator, device),
        "w_up": normal_init((d_model, d_ff), 1.0, dt, generator, device),
        "w_down": normal_init((d_ff, d_model), 1.0, dt, generator, device),
    }


def mlp_forward(p, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(x @ p.w_gate)
    return (gate * (x @ p.w_up)) @ p.w_down


class MLP(FrozenParams):
    def __init__(self, d_model: int, d_ff: int,
                 policy: DTypePolicy = DTypePolicy(),
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(init_mlp(d_model, d_ff, policy, generator, device))

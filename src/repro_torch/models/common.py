"""Shared model building blocks: dtype policy, initializer, RMS norm.

The torch counterparts of the JAX package's ``models/common.py`` that the
RWKV-6 serving path uses. Parameters are created from an explicit
``torch.Generator`` on the device they will live on; the JAX package's
RoPE, scan helpers and cost-probe mode have no use here (layers run as a
Python loop).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32


def normal_init(shape: Sequence[int], scale: float, dtype: torch.dtype,
                generator: Optional[torch.Generator] = None,
                device=None) -> torch.Tensor:
    """Normal draws with std ``scale / sqrt(fan_in)``, ``fan_in`` being
    ``shape[-2]`` (``shape[-1]`` for a vector), drawn in float32 and cast
    to ``dtype``. The generator must live on ``device``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(fan_in)
    x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device)
    return (x * std).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis, computed in float32 and cast back."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def init_rms_norm(d: int, dtype: torch.dtype, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def frozen(t: torch.Tensor) -> nn.Parameter:
    """A parameter that takes no gradient (the port only serves)."""
    return nn.Parameter(t, requires_grad=False)

"""Shared model building blocks: dtype policy, initializer, RMS norm,
rotary position embeddings, and the module that holds a layer's
parameters.

The torch counterparts of the JAX package's ``models/common.py`` that the
dense, RWKV-6 and RecurrentGemma serving paths use. Parameters are
created from an explicit ``torch.Generator`` on the device they will
live on; the JAX package's scan helpers and cost-probe mode have no
use here (layers run as a Python loop).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32

    @classmethod
    def bf16(cls) -> "DTypePolicy":
        return cls(torch.bfloat16, torch.bfloat16)


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
    """A parameter that takes no gradient: models are built for serving,
    and one built for training turns grads on with ``requires_grad_``
    (``transformer.init_model(..., trainable=True)``)."""
    return nn.Parameter(t, requires_grad=False)


class FrozenParams(nn.Module):
    """A module holding a dict of tensors as parameters, built without
    grads (:func:`frozen`), under the JAX package's parameter names; the
    ``*_forward`` functions read them as attributes."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        for name, t in params.items():
            self.register_parameter(name, frozen(t))


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(d_head: int, theta: float = 10000.0, device=None
               ) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S). Rotates the interleaved
    pairs (2i, 2i+1), as the JAX package does (not the two halves), with
    the angles in float32."""
    d_head = x.shape[-1]
    freqs = rope_freqs(d_head, theta, x.device)              # (Dh/2,)
    angles = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)

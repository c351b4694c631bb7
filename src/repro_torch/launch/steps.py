"""Step functions of the serving path.

``serve_step`` is the JAX package's ``build_serve_step`` body on one
device: one decode step against the cache, then greedy argmax (ties go
to the first index). There are no shardings to build.
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import LM, Cache, decode_step


@torch.inference_mode()
def serve_step(model: LM, cache: Cache, token: torch.Tensor,
               length: torch.Tensor):
    """Returns (next_token (B,) int32, logits (B, V), cache, length+1)."""
    logits, cache = decode_step(model, token, cache, length)
    next_token = torch.argmax(logits, dim=-1).to(torch.int32)
    return next_token, logits, cache, length + 1

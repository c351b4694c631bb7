"""Deterministic synthetic-token pipeline.

The counterpart of the JAX package's ``data/pipeline.py``: no corpus on
disk, so the pipeline synthesizes a deterministic pseudo-corpus, a
threefry stream over (seed, step) mixed through a fixed bigram sieve so
the stream has learnable low-order structure (the loss falls as a model
trains on it). The tokens equal the JAX package's bit for bit for any
(seed, step) in jax's non-partitionable threefry mode, which
:mod:`repro_torch.random` reproduces.

Determinism contract: ``batch(step)`` depends only on (seed, step), not
on worker count, restart point or shard layout. That is what makes a
restart replay exactly: after a restart at step k the batch of step k is
recomputed as it was.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch import DeviceLike, random as trandom, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structure: int = 97     # n-gram sieve modulus (learnable structure)


class SyntheticTokenPipeline:
    """``pipeline.batch(step)`` -> {"tokens", "labels"} (B, S) int32 on
    the pipeline's device; ``pipeline.shard(step, host, n_hosts)`` -> one
    host's rows."""

    def __init__(self, cfg: DataConfig, *, torch_device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(torch_device)

    def _tokens(self, step: int) -> torch.Tensor:
        c = self.cfg
        key = trandom.fold_in(trandom.PRNGKey(c.seed, self.device), step)
        base = trandom.randint(key, (c.global_batch, c.seq_len + 1), 0,
                               c.vocab)
        # bigram sieve: every odd position is a deterministic function of
        # its (unmixed, even) predecessor -> observably learnable structure
        prev = torch.roll(base, 1, dims=1)
        odd = torch.arange(c.seq_len + 1, device=self.device) % 2 == 1
        mixed = torch.where(odd[None, :],
                            (prev * 31 + 7) % min(c.structure, c.vocab),
                            base % c.vocab)
        mixed[:, 0] = base[:, 0]
        return mixed

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        toks = self._tokens(step)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def shard(self, step: int, host: int,
              n_hosts: int) -> Dict[str, torch.Tensor]:
        b = self.batch(step)
        per = self.cfg.global_batch // n_hosts
        sl = slice(host * per, (host + 1) * per)
        return {k: v[sl] for k, v in b.items()}


def make_batch_specs(cfg, shape, *, dtype: torch.dtype = torch.int32
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) per key of one global batch of the shape cell
    ``shape`` (a ``ShapeCell``) for the model config ``cfg``: audio
    takes frame embeddings and frame labels; vlm a prefix of
    ``frontend_prefix`` patch embeddings and the text tokens and labels
    of the rest of the sequence; the other families tokens and labels.
    Embeddings are bfloat16, as the JAX package specifies them."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        return {"embeds": ((b, s, cfg.d_model), torch.bfloat16),
                "labels": ((b, s), dtype)}
    if cfg.family == "vlm":
        p = cfg.frontend_prefix
        return {"embeds": ((b, p, cfg.d_model), torch.bfloat16),
                "tokens": ((b, s - p), dtype),
                "labels": ((b, s - p), dtype)}
    return {"tokens": ((b, s), dtype), "labels": ((b, s), dtype)}

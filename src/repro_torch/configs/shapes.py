"""Assigned input shapes (the 4 shape cells per LM architecture), from
the JAX package's ``configs/shapes.py``, which imports no framework.

``train_*`` cells are for a train step (not ported); ``prefill_*`` run
the prompt pass; ``decode_*`` / ``long_*`` run ``serve_step``: one new
token against a KV cache / recurrent state of the given ``seq_len``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", "train", 4_096, 256),
    ShapeCell("prefill_32k", "prefill", 32_768, 32),
    ShapeCell("decode_32k", "decode", 32_768, 128),
    ShapeCell("long_500k", "decode", 524_288, 1),
)


def get_shape(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def applicable(cfg, shape: ShapeCell) -> Tuple[bool, str]:
    """(runs?, reason). Encoder-only archs skip decode; full-attention
    archs skip long_500k (needs sub-quadratic attention)."""
    if shape.kind == "decode" and cfg.encoder_only:
        return False, "encoder-only: no decode step"
    if shape.name == "long_500k":
        if cfg.encoder_only:
            return False, "encoder-only: no decode step"
        if not cfg.sub_quadratic:
            return False, "full softmax attention is O(S) per decode token " \
                          "with an O(S) cache: not sub-quadratic"
    return True, ""

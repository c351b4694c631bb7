"""Architecture configuration schema (from the JAX package's
``configs/base.py``, which imports no framework).

It keeps the fields, the ``param_count`` branches and the ``reduced()``
entries that the served families read: ``dense`` (GQA with qk-norm or
QKV bias, SwiGLU), ``ssm`` (RWKV-6) and ``hybrid`` (RecurrentGemma:
RG-LRU and local-attention layers).

One :class:`ModelConfig` per ported architecture lives in
``repro_torch/configs/<id>.py``; ``repro_torch.configs.get_config(name)``
resolves them, and ``.reduced()`` produces the family-preserving small
variant the CPU tests instantiate.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

PORTED_FAMILIES = ("dense", "ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                  # 0 for attention-free (rwkv)
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None  # defaults to d_model // n_heads

    # dense-attention extras
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0

    # hybrid / recurrent (recurrentgemma)
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rglru", "rglru", "local")
    local_window: int = 2048
    rg_conv_width: int = 4
    rg_lru_width: Optional[int] = None    # defaults to d_model

    # structure
    encoder_only: bool = False            # bidirectional, no decode
    tie_embeddings: bool = False

    # runtime
    max_seq: int = 1_048_576
    sub_quadratic: bool = False           # can run long_500k decode

    def __post_init__(self):
        if self.d_head is None and self.n_heads:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    def param_count(self) -> int:
        """Analytical parameter count (excludes biases/norms ~<0.1%)."""
        if self.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"param_count of family {self.family!r} is not ported")
        d = self.d_model
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            # rwkv6 time-mix: 5 projections d^2 + ddlerp lora (5-way, r=32)
            # + decay lora (2r) + mixes/bonus; channel mix: 2 d*ff + r-gate
            lora = 32
            per_layer = (5 * d * d + 10 * lora * d + 4 * lora * d
                         + 9 * d) + (2 * d * self.d_ff + d * d + 2 * d)
        elif self.family == "dense":
            dh = self.d_head
            per_layer = (d * self.n_heads * dh            # q
                         + 2 * d * self.n_kv_heads * dh   # k, v
                         + self.n_heads * dh * d          # o
                         + 3 * d * self.d_ff)             # swiglu
        else:
            # mixture of rglru + local-attn layers; approximate with the
            # pattern-weighted average
            pat = self.block_pattern or ("rglru",)
            n_rec = sum(1 for p in pat if p == "rglru") / len(pat)
            w = self.rg_lru_width or d
            rec = 2 * d * w + w * d + 4 * w  # gates + in/out proj + conv
            attn = (d * self.n_heads * self.d_head
                    + 2 * d * self.n_kv_heads * self.d_head
                    + self.n_heads * self.d_head * d)
            per_layer = n_rec * rec + (1 - n_rec) * attn + 3 * d * self.d_ff
        return int(emb + self.n_layers * per_layer)

    def reduced(self) -> "ModelConfig":
        """Family-preserving tiny config for CPU smoke tests."""
        pat = self.block_pattern
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(2, len(pat) or 2),
            d_model=64,
            n_heads=max(1, min(4, self.n_heads)),
            n_kv_heads=max(1, min(2, self.n_kv_heads)),
            d_head=16,
            d_ff=128,
            vocab=128,
            local_window=32,
            rg_lru_width=64 if self.rg_lru_width else None,
            max_seq=512,
        )


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to "
            "repro_torch yet (ROADMAP, queue 1, item 12); ported: "
            f"{PORTED_FAMILIES}")


def hybrid_layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(groups, tail layers) of a hybrid config: ``n_layers`` split into
    groups of ``len(block_pattern)`` and the remainder."""
    pat = len(cfg.block_pattern)
    n_groups = cfg.n_layers // pat
    return n_groups, cfg.n_layers - n_groups * pat

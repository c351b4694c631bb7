"""Architecture configuration schema (from the JAX package's
``configs/base.py``, which imports no framework).

It keeps the fields, the ``param_count`` branches and the ``reduced()``
entries that the port's families read: ``dense`` (GQA with qk-norm or
QKV bias, SwiGLU), ``vlm`` (the dense backbone behind a prefix of stub
patch embeddings), ``audio`` (bidirectional dense layers over stub frame
embeddings), ``moe`` (MLA or GQA attention and routed top-k experts with
shared ones: DeepSeek-V2, Llama-4), ``ssm`` (RWKV-6) and ``hybrid``
(RecurrentGemma: RG-LRU and local-attention layers). The JAX package's
``unroll_layers`` (its cost-probe mode) has no use here.

One :class:`ModelConfig` per ported architecture lives in
``repro_torch/configs/<id>.py``; ``repro_torch.configs.get_config(name)``
resolves them, and ``.reduced()`` produces the family-preserving small
variant the CPU tests instantiate.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

PORTED_FAMILIES = ("dense", "vlm", "audio", "moe", "ssm", "hybrid")


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

    # MLA (DeepSeek-V2)
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1            # 1 = every layer, 2 = interleaved (llama4)
    first_dense: int = 0          # leading dense layers (deepseek)
    dense_d_ff: int = 0           # d_ff of those dense layers
    capacity_factor: float = 1.25

    # hybrid / recurrent (recurrentgemma)
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rglru", "rglru", "local")
    local_window: int = 2048
    rg_conv_width: int = 4
    rg_lru_width: Optional[int] = None    # defaults to d_model

    # structure
    encoder_only: bool = False            # hubert: bidirectional, no decode
    frontend: Optional[str] = None        # None | "audio" | "vision"
    frontend_prefix: int = 0              # prefix embeddings length (vlm)
    tie_embeddings: bool = False

    # runtime
    max_seq: int = 1_048_576
    sub_quadratic: bool = False           # can run long_500k decode

    def __post_init__(self):
        if self.d_head is None and self.n_heads:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    def _attn_params(self) -> int:
        """One layer's attention projections: MLA's down/up projections
        and output, or GQA's q, k, v and o."""
        d = self.d_model
        if self.use_mla:
            qd = self.q_lora_rank or d
            h = self.n_heads
            return (d * self.q_lora_rank
                    + qd * h * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                    + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                    + self.kv_lora_rank * h * (self.qk_nope_head_dim
                                               + self.v_head_dim)
                    + h * self.v_head_dim * d)
        dh = self.d_head
        return (d * self.n_heads * dh            # q
                + 2 * d * self.n_kv_heads * dh   # k, v
                + self.n_heads * dh * d)         # o

    def moe_layout(self) -> Tuple[int, int]:
        """(MoE layers, dense layers) of a ``moe`` config, as the JAX
        package's ``param_count`` counts them."""
        n_moe = (self.n_layers - self.first_dense) // self.moe_every
        return n_moe, self.n_layers - n_moe

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
        elif self.moe:
            return self._moe_count(self.n_experts)
        elif self.family in ("dense", "vlm", "audio"):
            per_layer = self._attn_params() + 3 * d * self.d_ff  # swiglu
        else:
            # mixture of rglru + local-attn layers; approximate with the
            # pattern-weighted average
            pat = self.block_pattern or ("rglru",)
            n_rec = sum(1 for p in pat if p == "rglru") / len(pat)
            w = self.rg_lru_width or d
            rec = 2 * d * w + w * d + 4 * w  # gates + in/out proj + conv
            per_layer = (n_rec * rec + (1 - n_rec) * self._attn_params()
                         + 3 * d * self.d_ff)
        return int(emb + self.n_layers * per_layer)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared only)."""
        if not self.moe:
            return self.param_count()
        return self._moe_count(self.top_k, router=False)

    def _moe_count(self, experts: int, router: bool = True) -> int:
        """A ``moe`` config's count with ``experts`` routed experts a MoE
        layer (and the router's weights when ``router``), as the JAX
        package's ``param_count`` / ``active_param_count`` give it."""
        d = self.d_model
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        n_moe, n_dense = self.moe_layout()
        expert = 3 * d * self.moe_d_ff
        moe_p = (experts + self.n_shared_experts) * expert \
            + (d * self.n_experts if router else 0)
        dff = self.dense_d_ff or self.d_ff
        ffn = n_moe * moe_p + n_dense * 3 * d * dff
        return int(emb + self.n_layers * self._attn_params() + ffn)

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
            kv_lora_rank=16 if self.use_mla else 0,
            q_lora_rank=24 if self.use_mla else 0,
            qk_nope_head_dim=16 if self.use_mla else self.qk_nope_head_dim,
            qk_rope_head_dim=8 if self.use_mla else self.qk_rope_head_dim,
            v_head_dim=16 if self.use_mla else self.v_head_dim,
            n_experts=8 if self.moe else 0,
            top_k=min(2, self.top_k) if self.moe else 0,
            n_shared_experts=min(1, self.n_shared_experts),
            moe_d_ff=32 if self.moe else 0,
            dense_d_ff=128 if self.dense_d_ff else 0,
            local_window=32,
            rg_lru_width=64 if self.rg_lru_width else None,
            frontend_prefix=min(4, self.frontend_prefix),
            max_seq=512,
        )


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not one of the JAX "
            f"package's families that repro_torch holds: {PORTED_FAMILIES}")
    if cfg.family == "moe" and cfg.moe_every == 1 and not cfg.use_mla:
        # the JAX package builds ``moe_layers`` for this combination but
        # its prefill/decode_step read ``layers`` (ROADMAP, R10)
        raise ValueError(
            f"{cfg.name}: a moe config with moe_every == 1 needs use_mla "
            "(uniform GQA MoE layers have no serving path in the JAX "
            "package; ROADMAP R10)")


def hybrid_layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(groups, tail layers) of a hybrid config: ``n_layers`` split into
    groups of ``len(block_pattern)`` and the remainder."""
    pat = len(cfg.block_pattern)
    n_groups = cfg.n_layers // pat
    return n_groups, cfg.n_layers - n_groups * pat

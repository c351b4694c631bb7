"""Architecture configuration schema (from the JAX package's
``configs/base.py``, which imports no framework).

It keeps the fields, the ``param_count`` branch and the ``reduced()``
entries that the ported ``ssm`` family reads; the other families' fields
come back with the slice that first reads them.

One :class:`ModelConfig` per ported architecture lives in
``repro_torch/configs/<id>.py``; ``repro_torch.configs.get_config(name)``
resolves them, and ``.reduced()`` produces the family-preserving small
variant the CPU tests instantiate.
"""
from __future__ import annotations

import dataclasses


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
    tie_embeddings: bool = False

    def param_count(self) -> int:
        """Analytical parameter count (excludes biases/norms ~<0.1%)."""
        if self.family != "ssm":
            raise NotImplementedError(
                f"param_count of family {self.family!r} is not ported")
        d = self.d_model
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        # rwkv6 time-mix: 5 projections d^2 + ddlerp lora (5-way, r=32)
        # + decay lora (2r) + mixes/bonus; channel mix: 2 d*ff + r-gate
        lora = 32
        per_layer = (5 * d * d + 10 * lora * d + 4 * lora * d
                     + 9 * d) + (2 * d * self.d_ff + d * d + 2 * d)
        return int(emb + self.n_layers * per_layer)

    def reduced(self) -> "ModelConfig":
        """Family-preserving tiny config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=max(1, min(4, self.n_heads)),
            n_kv_heads=max(1, min(2, self.n_kv_heads)),
            d_ff=128,
            vocab=128,
        )

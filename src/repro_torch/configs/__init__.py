"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``.

It holds every architecture of the JAX package: the dense family
(``smollm-135m``, ``qwen2.5-14b``, ``qwen3-8b``, ``yi-6b``), the vlm
(``internvl2-26b``) and audio (``hubert-xlarge``) families, the moe
family (``deepseek-v2-236b``, ``llama4-maverick-400b-a17b``),
RecurrentGemma (``recurrentgemma-9b``) and RWKV-6 (``rwkv6-3b``).
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import SHAPES, ShapeCell, applicable, get_shape

_MODULES: Dict[str, str] = {
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
}

# architectures of the JAX package that the port does not hold yet
_NOT_PORTED: Tuple[str, ...] = ()

ARCH_NAMES: Tuple[str, ...] = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet (ROADMAP, "
            f"queue 1, item 12: the LM substrate); ported: {ARCH_NAMES}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    return importlib.import_module(_MODULES[name]).CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}


__all__ = ["ModelConfig", "ShapeCell", "SHAPES", "ARCH_NAMES",
           "get_config", "all_configs", "get_shape", "applicable"]

"""internvl2-26b [vlm]: InternViT frontend (stubbed patch embeddings) +
InternLM2-20B backbone. [arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    frontend="vision",
    frontend_prefix=256,   # precomputed ViT patch embeddings per image
)

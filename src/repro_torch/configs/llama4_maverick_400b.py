"""llama4-maverick-400b-a17b [moe]: GQA + 128-expert top-1 MoE
interleaved 1:1 with dense layers; early-fusion multimodal (frontend
stubbed). [hf:meta-llama/Llama-4-Scout-17B-16E family; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    moe=True,
    n_experts=128,
    top_k=1,
    n_shared_experts=1,
    moe_d_ff=8192,
    moe_every=2,           # interleaved dense/MoE
    rope_theta=500_000.0,
)

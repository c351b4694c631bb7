"""hubert-xlarge [audio]: encoder-only transformer over stub conv-frontend
frame embeddings; 504-class frame targets. [arXiv:2106.07447; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    encoder_only=True,
    frontend="audio",
)

"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 2:1 pattern
(rglru, rglru, local) x 12 + 2-layer recurrent tail = 38 layers.
[arXiv:2402.19427; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,          # MQA in the attention layers
    d_ff=12288,
    vocab=256000,
    block_pattern=("rglru", "rglru", "local"),
    local_window=2048,
    rg_lru_width=4096,
    sub_quadratic=True,    # state is O(window): runs long_500k
    tie_embeddings=True,
)

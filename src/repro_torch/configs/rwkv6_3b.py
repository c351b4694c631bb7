"""rwkv6-3b [ssm]: Finch — attention-free, data-dependent decay.
[arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=0,             # attention-free
    n_kv_heads=0,
    d_head=0,
    d_ff=8960,
    vocab=65536,
    sub_quadratic=True,    # O(1) state: runs long_500k
)

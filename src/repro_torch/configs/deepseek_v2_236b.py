"""deepseek-v2-236b [moe]: MLA (kv_lora=512) + 2 shared / 160 routed
top-6 experts; first layer dense. [arXiv:2405.04434; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,        # MLA: per-head keys derived from the latent
    d_ff=1536,             # per-expert intermediate
    vocab=102400,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    moe=True,
    n_experts=160,
    top_k=6,
    n_shared_experts=2,
    moe_d_ff=1536,
    first_dense=1,
    dense_d_ff=12288,
)

"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (GQA kv=16) per-expert
d_ff=1408, vocab=151936, MoE 60 routed top-4 + 4 shared
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=151936,
    head_dim=128,
    n_experts=60,
    n_experts_per_tok=4,
    n_shared_experts=4,
    rope_theta=1000000.0,
)

REDUCED = CONFIG.replace(
    name="qwen2-moe-reduced",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=128,
    moe_d_ff=128, vocab_size=512, head_dim=64,
    n_experts=4, n_experts_per_tok=2, n_shared_experts=1, loss_chunks=1,
)

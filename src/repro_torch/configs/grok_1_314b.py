"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) per-expert
d_ff=32768, vocab=131072, MoE 8 experts top-2 [hf:xai-org/grok-1]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    moe_d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    n_experts=8,
    n_experts_per_tok=2,
    n_shared_experts=0,
)

REDUCED = CONFIG.replace(
    name="grok-1-reduced",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
    moe_d_ff=512, vocab_size=512, head_dim=64,
    n_experts=4, n_experts_per_tok=2, loss_chunks=1,
)

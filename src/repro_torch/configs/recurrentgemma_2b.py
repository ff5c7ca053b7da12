"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1, head_dim
256) d_ff=7680 vocab=256000 — RG-LRU + local attention (window 2048),
pattern (rec, rec, attn) [arXiv:2402.19427]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    sliding_window=2048,
    block_pattern=("rec", "rec", "attn"),
    conv_width=4,
    rglru_c=8.0,
    embed_scale=True,
    tie_embeddings=True,
    supports_long_context=True,
    long_context_window=2048,
)

REDUCED = CONFIG.replace(
    name="recurrentgemma-reduced",
    n_layers=3, d_model=256, n_heads=2, n_kv_heads=1, d_ff=512,
    vocab_size=512, head_dim=128, sliding_window=64, loss_chunks=1,
)

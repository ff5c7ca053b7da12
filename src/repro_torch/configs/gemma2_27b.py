"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000 — local+global alternating (window 4096), attn softcap 50,
logit softcap 30, sandwich post-norms, sqrt(d) embed scaling
[arXiv:2408.00118].

long_500k: runs with every layer windowed (the beyond-model-card
sub-quadratic serving variant; DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab_size=256000,
    head_dim=128,
    rope_theta=10000.0,
    logit_softcap=30.0,
    attn_softcap=50.0,
    sliding_window=4096,
    local_global_period=2,       # L, G, L, G, ...
    post_norms=True,
    embed_scale=True,
    tie_embeddings=True,
    query_scale=(4608 / 32) ** -0.5,
    supports_long_context=True,
    long_context_window=4096,
)

REDUCED = CONFIG.replace(
    name="gemma2-27b-reduced",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
    vocab_size=512, head_dim=64, sliding_window=64, loss_chunks=1,
    query_scale=(256 / 4) ** -0.5,
)

"""mamba2-2.7b [ssm]: 64L d_model=2560, attention-free SSD with
ssm_state=128, head_dim P=64 (=> 80 ssm heads at expand=2),
vocab=50280 [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,            # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=64,
    conv_width=4,
    tie_embeddings=True,
    supports_long_context=True,
)

REDUCED = CONFIG.replace(
    name="mamba2-reduced",
    n_layers=2, d_model=256, vocab_size=512, ssm_state=32,
    ssm_head_dim=32, ssm_chunk=16, loss_chunks=1,
)

"""whisper-medium [audio enc-dec]: 24 encoder + 24 decoder layers,
d_model=1024 16H (kv=16) d_ff=4096 vocab=51865; conv mel frontend STUBBED
(input_specs supplies (B, 1500, 1024) frame embeddings) [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,          # decoder layers
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    n_audio_frames=1500,
    tie_embeddings=True,
)

REDUCED = CONFIG.replace(
    name="whisper-reduced",
    n_layers=2, n_enc_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
    d_ff=512, vocab_size=512, head_dim=64, n_audio_frames=64, loss_chunks=1,
)

"""internvl2-26b [vlm]: InternLM2-20B language backbone — 48L d_model=6144
48H (GQA kv=8) d_ff=16384 vocab=92553 — consuming stubbed InternViT patch
embeddings (256 visual tokens scattered into the sequence prefix)
[arXiv:2404.16821].  The ViT-6B vision tower + MLP projector is a stub:
the batch supplies (B, 256, d_model) pre-projected patch embeddings
(``visual_embeds``)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    head_dim=128,
    n_visual_tokens=256,
    rope_theta=1000000.0,
)

REDUCED = CONFIG.replace(
    name="internvl2-reduced",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
    vocab_size=512, head_dim=64, n_visual_tokens=16, loss_chunks=1,
)

"""Configuration system: architecture + input-shape configs.

A copy of ``repro.configs.base`` with ``dtype`` a torch dtype, cut to the
fields of the ported families (dense, vlm, hybrid) and training: the MoE,
SSM, enc-dec and dry-run fields wait for the slice that ports them
(ROADMAP queue 1 item 16).  Each ported architecture has a module
``repro_torch/configs/<id>.py`` exporting ``CONFIG`` (exact published
spec, source cited) and ``REDUCED`` (the small smoke variant), the
reference's values of those fields.  ``repro_torch.configs.get(name)``
resolves either by arch id.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | hybrid | vlm (the others are not ported)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # gemma2-style extras
    logit_softcap: float | None = None
    attn_softcap: float | None = None
    sliding_window: int | None = None   # window size of local layers
    local_global_period: int = 0        # every k-th layer is GLOBAL (0 = all global)
    post_norms: bool = False            # gemma2 sandwich norms
    query_scale: float | None = None    # gemma2 query_pre_attn_scalar
    embed_scale: bool = False           # gemma-style sqrt(d) embedding scaling
    # hybrid (recurrentgemma): block pattern, e.g. ("rec", "rec", "attn")
    block_pattern: tuple[str, ...] = ()
    rglru_c: float = 8.0
    conv_width: int = 4                 # temporal conv of the recurrent block
    # vlm
    n_visual_tokens: int = 0            # prefix patch-embedding tokens (stub)
    # numerics
    dtype: Any = torch.bfloat16
    # long-context: archs that can serve long_500k (sub-quadratic path)
    supports_long_context: bool = False
    long_context_window: int = 4096
    # training
    learning_rate: float = 3e-4
    remat: bool = True                  # checkpoint every block in the backward pass
    loss_chunks: int = 8                # token chunks of the cross-entropy

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Approximate parameter count, the reference's formula for the
        ported families (the recurrent blocks are counted as attention, as
        there)."""
        if self.family not in ("dense", "vlm", "hybrid"):
            raise NotImplementedError(
                f"the {self.family!r} family is not ported (ROADMAP queue 1 item 16)")
        d, hd = self.d_model, self.head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        per = attn + 3 * d * self.d_ff + 2 * d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per + emb


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

"""Configuration system: architecture + input-shape configs.

A copy of ``repro.configs.base`` with ``dtype`` a torch dtype.  Every field
of the reference is here with its default except ``scan_unroll``, a knob of
JAX's layer scan (the dry run's cost analysis) that the port, which loops
over the layers in Python, has no use for.  Each architecture has a module
``repro_torch/configs/<id>.py`` exporting ``CONFIG`` (exact published spec,
source cited) and ``REDUCED`` (the small smoke variant), the reference's
values.  ``repro_torch.configs.get(name)`` resolves either by arch id.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
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
    # MoE
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int | None = None         # per-expert hidden (defaults to d_ff)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    conv_width: int = 4                 # temporal conv of the ssm and recurrent blocks
    # hybrid (recurrentgemma): block pattern, e.g. ("rec", "rec", "attn")
    block_pattern: tuple[str, ...] = ()
    rglru_c: float = 8.0
    # enc-dec (whisper)
    n_enc_layers: int = 0
    n_audio_frames: int = 1500          # conv-frontend output length (stub)
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

    @property
    def moe_hidden(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    def param_count(self) -> int:
        """Approximate parameter count, the reference's formula (the
        recurrent blocks are counted as attention, as there)."""
        d, hd = self.d_model, self.head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.family == "ssm":
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_head_dim
            per = (
                d * (2 * d_in + 2 * self.ssm_state + nh)   # in_proj(z,x,B,C,dt)
                + self.conv_width * (d_in + 2 * self.ssm_state)
                + d_in * d                                  # out_proj
                + d_in + 2 * nh                             # norm, A, D
            )
            return self.n_layers * per + 2 * self.vocab_size * d
        mlp = 3 * d * self.d_ff
        if self.family == "moe":
            mlp = 3 * d * self.moe_hidden * (self.n_experts + self.n_shared_experts)
            mlp += d * self.n_experts                       # router
        per = attn + mlp + 2 * d
        total = self.n_layers * per
        if self.family == "encdec":
            total += self.n_enc_layers * (attn + 3 * d * self.d_ff + 2 * d)
            total += self.n_layers * attn                   # cross-attention
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return total + emb

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dense_like = self.replace(family="dense", d_ff=0).param_count()
        active_mlp = (
            3 * d * self.moe_hidden
            * (self.n_experts_per_tok + self.n_shared_experts)
        )
        return dense_like + self.n_layers * active_mlp


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

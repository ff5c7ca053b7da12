"""Whisper-style encoder-decoder transformer backbone (arXiv:2212.04356);
the full-sequence (train, prefill) and decode paths of
``repro.models.encdec``.

The mel-spectrogram + conv feature extractor is a stub, as in the
reference: the caller supplies frame embeddings (B, n_audio_frames,
d_model) as ``batch["audio_embeds"]``.  The backbone is a bidirectional
encoder with sinusoidal positions and a causal decoder with self- and
cross-attention; the decoder's absolute positions use the same sinusoidal
table (the reference's recorded deviation from whisper's learned table).
The MLPs are the gated ``swiglu`` with the tanh GELU (``L.gelu``, which is
``jax.nn.gelu``'s default).

Per-layer parameters are stacked along a leading layer axis; with
``cfg.remat`` every encoder and decoder block is checkpointed.  In decode
the self-attention has no window and no soft-cap, so it takes the "global"
window (``transformer.GLOBAL_WINDOW``) and runs the ``swa_decode`` kernel on
the card; the cross-attention over the frozen encoder K/V is the plain
``full_attention`` with ``cross_kv``, as the reference's plain ``jnp`` is.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.transformer import GLOBAL_WINDOW


class EncBlock(NamedTuple):
    ln1: torch.Tensor
    attn: attn.AttnParams
    ln2: torch.Tensor
    w_gate: torch.Tensor
    w_up: torch.Tensor
    w_down: torch.Tensor


class DecBlock(NamedTuple):
    ln1: torch.Tensor
    self_attn: attn.AttnParams
    ln_x: torch.Tensor
    cross_attn: attn.AttnParams
    ln2: torch.Tensor
    w_gate: torch.Tensor
    w_up: torch.Tensor
    w_down: torch.Tensor


class Params(NamedTuple):
    enc_blocks: EncBlock          # stacked (n_enc_layers, ...)
    enc_final: torch.Tensor
    embed: torch.Tensor
    dec_blocks: DecBlock          # stacked (n_layers, ...)
    final_norm: torch.Tensor


def _attn_init(g: torch.Generator, cfg: ModelConfig) -> attn.AttnParams:
    return attn.init(g, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, False, cfg.dtype)


def _norm(g: torch.Generator, cfg: ModelConfig) -> torch.Tensor:
    return torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=g.device)


def _init_enc(g: torch.Generator, cfg: ModelConfig) -> EncBlock:
    d, ff = cfg.d_model, cfg.d_ff
    return EncBlock(
        ln1=_norm(g, cfg), attn=_attn_init(g, cfg), ln2=_norm(g, cfg),
        w_gate=L.dense_init(g, (d, ff), cfg.dtype),
        w_up=L.dense_init(g, (d, ff), cfg.dtype),
        w_down=L.dense_init(g, (ff, d), cfg.dtype),
    )


def _init_dec(g: torch.Generator, cfg: ModelConfig) -> DecBlock:
    d, ff = cfg.d_model, cfg.d_ff
    return DecBlock(
        ln1=_norm(g, cfg), self_attn=_attn_init(g, cfg), ln_x=_norm(g, cfg),
        cross_attn=_attn_init(g, cfg), ln2=_norm(g, cfg),
        w_gate=L.dense_init(g, (d, ff), cfg.dtype),
        w_up=L.dense_init(g, (d, ff), cfg.dtype),
        w_down=L.dense_init(g, (ff, d), cfg.dtype),
    )


def init(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """Random params with the reference's distributions and dtypes, drawn
    on the generator's device."""
    return Params(
        enc_blocks=L.stack_layers(lambda: _init_enc(generator, cfg), cfg.n_enc_layers),
        enc_final=_norm(generator, cfg),
        embed=L.embed_init(generator, cfg.vocab_size, cfg.d_model, cfg.dtype),
        dec_blocks=L.stack_layers(lambda: _init_dec(generator, cfg), cfg.n_layers),
        final_norm=_norm(generator, cfg),
    )


def axes(cfg: ModelConfig) -> Params:
    """Logical sharding axes, the structure of :class:`Params`."""
    a = attn.layer_axes(False)
    return Params(
        enc_blocks=EncBlock(
            ln1=("layers", "embed"), attn=a, ln2=("layers", "embed"),
            w_gate=("layers", "embed", "ff"), w_up=("layers", "embed", "ff"),
            w_down=("layers", "ff", "embed"),
        ),
        enc_final=("embed",),
        embed=("vocab", "embed"),
        dec_blocks=DecBlock(
            ln1=("layers", "embed"), self_attn=a, ln_x=("layers", "embed"),
            cross_attn=a, ln2=("layers", "embed"),
            w_gate=("layers", "embed", "ff"), w_up=("layers", "embed", "ff"),
            w_down=("layers", "ff", "embed"),
        ),
        final_norm=("embed",),
    )


def from_numpy(tree, device: torch.device | str | None = None) -> Params:
    """The reference's ``Params`` with numpy leaves (``jax.tree.map(
    np.asarray, params)``) -> the port's on ``device``, bit for bit."""
    dev = _device.resolve(device)

    def t(a):
        return None if a is None else L.tensor_from_array(a, dev)

    def a(p):
        return attn.AttnParams(*(t(x) for x in p))

    e, d = tree.enc_blocks, tree.dec_blocks
    return Params(
        enc_blocks=EncBlock(t(e.ln1), a(e.attn), t(e.ln2), t(e.w_gate), t(e.w_up), t(e.w_down)),
        enc_final=t(tree.enc_final),
        embed=t(tree.embed),
        dec_blocks=DecBlock(t(d.ln1), a(d.self_attn), t(d.ln_x), a(d.cross_attn), t(d.ln2),
                            t(d.w_gate), t(d.w_up), t(d.w_down)),
        final_norm=t(tree.final_norm),
    )


def to_numpy(params: Params) -> Params:
    """The inverse of :func:`from_numpy`: host numpy leaves (bf16 as f32)."""
    return L.map_leaves(L.array_from_tensor, params)


def _mlp(bp, x: torch.Tensor) -> torch.Tensor:
    return L.swiglu(L.rms_norm(x, bp.ln2), bp.w_gate, bp.w_up, bp.w_down, act=L.gelu)


def _enc_block(bp: EncBlock, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    h = attn.full_attention(bp.attn, L.rms_norm(x, bp.ln1), positions, rope_theta=None,
                            causal=False)
    x = x + h
    return x + _mlp(bp, x)


def encode(params: Params, audio_embeds: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Bidirectional encoder over stubbed frame embeddings (b, t_a, d)."""
    b, t_a, d = audio_embeds.shape
    pos = L.sinusoidal_positions(t_a, d, audio_embeds.device).to(audio_embeds.dtype)
    x = audio_embeds + pos[None]
    positions = torch.arange(t_a, device=x.device).expand(b, t_a)
    for bp in L.unstack_layers(params.enc_blocks, cfg.n_enc_layers):
        if cfg.remat:
            x = checkpoint(_enc_block, bp, x, positions, use_reentrant=False)
        else:
            x = _enc_block(bp, x, positions)
    return L.rms_norm(x, params.enc_final)


def _dec_block(bp: DecBlock, x: torch.Tensor, positions: torch.Tensor,
               enc_out: torch.Tensor) -> torch.Tensor:
    h = attn.full_attention(bp.self_attn, L.rms_norm(x, bp.ln1), positions, rope_theta=None)
    x = x + h
    ekv_k = torch.einsum("btd,dhk->bthk", enc_out, bp.cross_attn.wk)
    ekv_v = torch.einsum("btd,dhk->bthk", enc_out, bp.cross_attn.wv)
    h = attn.full_attention(bp.cross_attn, L.rms_norm(x, bp.ln_x), positions, rope_theta=None,
                            cross_kv=(ekv_k, ekv_v), causal=False)
    x = x + h
    return x + _mlp(bp, x)


def forward(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Decoder hidden states after the final norm: (b, s, d).
    ``batch["tokens"]`` (b, s) int, ``batch["audio_embeds"]`` (b, t_a, d)."""
    enc_out = encode(params, batch["audio_embeds"], cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    pos_tab = L.sinusoidal_positions(s, cfg.d_model, tokens.device).to(cfg.dtype)
    x = params.embed[tokens] + pos_tab[None]
    positions = torch.arange(s, device=x.device).expand(b, s)
    for bp in L.unstack_layers(params.dec_blocks, cfg.n_layers):
        if cfg.remat:
            x = checkpoint(_dec_block, bp, x, positions, enc_out, use_reentrant=False)
        else:
            x = _dec_block(bp, x, positions, enc_out)
    return L.rms_norm(x, params.final_norm)


def loss(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy through the tied embedding, f32 scalar."""
    h = forward(params, batch, cfg)
    b, s, d = h.shape
    return L.chunked_cross_entropy(
        h[:, :-1].reshape(-1, d), params.embed.T, batch["tokens"][:, 1:].reshape(-1),
        torch.ones((b * (s - 1),), dtype=torch.float32, device=h.device),
        n_chunks=cfg.loss_chunks,
    )


class DecodeCache(NamedTuple):
    kv: attn.KVCache            # decoder self-attention caches, stacked (layers, ...)
    cross_k: torch.Tensor       # (layers, b, t_a, kv, hd), frozen
    cross_v: torch.Tensor


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, long_context: bool = False,
               device: torch.device | str | None = None) -> DecodeCache:
    """Zero self-attention caches and zero cross K/V, as the reference's;
    a caller fills the cross K/V with :func:`precompute_cross_kv`."""
    dev = _device.resolve(device)
    x_shape = (cfg.n_layers, batch, cfg.n_audio_frames, cfg.n_kv_heads, cfg.head_dim)
    return DecodeCache(
        kv=attn.init_layer_caches(cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim,
                                  cfg.dtype, dev),
        cross_k=torch.zeros(x_shape, dtype=cfg.dtype, device=dev),
        cross_v=torch.zeros(x_shape, dtype=cfg.dtype, device=dev),
    )


def precompute_cross_kv(params: Params, enc_out: torch.Tensor,
                        cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V from the encoder output, all layers at once:
    two (layers, b, t_a, kv, hd) tensors."""
    ck = torch.einsum("btd,ldhk->lbthk", enc_out, params.dec_blocks.cross_attn.wk)
    cv = torch.einsum("btd,ldhk->lbthk", enc_out, params.dec_blocks.cross_attn.wv)
    return ck, cv


def step_position(step: torch.Tensor, d: int) -> torch.Tensor:
    """The sinusoid of position ``step`` (a 0-d int tensor), (d,) f32, as
    the reference evaluates it at each decode step."""
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=step.device)
                    * (-math.log(10000.0) / d))
    angle = step.to(torch.float32) * div
    pos = torch.zeros((d,), dtype=torch.float32, device=step.device)
    pos[0::2] = torch.sin(angle)
    pos[1::2] = torch.cos(angle)
    return pos


def decode_step(params: Params, cache: DecodeCache, tokens: torch.Tensor, cfg: ModelConfig,
                long_context: bool = False) -> tuple[DecodeCache, torch.Tensor]:
    """Serve one token for the whole batch; returns (cache, logits (b, 1,
    vocab) f32).  The position is the first layer's first row's length."""
    del long_context
    pos_vec = step_position(cache.kv.length[0, 0], cfg.d_model)
    x = params.embed[tokens] + pos_vec.to(cfg.dtype)[None, None, :]
    zeros = torch.zeros((x.shape[0], 1), dtype=torch.int32, device=x.device)
    lengths = []
    for i in range(cfg.n_layers):
        bp = L.layer_slice(params.dec_blocks, i)
        kv = attn.KVCache(cache.kv.k[i], cache.kv.v[i], cache.kv.length[i])
        kv, h = attn.decode_step(bp.self_attn, kv, L.rms_norm(x, bp.ln1), window=GLOBAL_WINDOW,
                                 rope_theta=None)
        lengths.append(kv.length)
        x = x + h
        h = attn.full_attention(bp.cross_attn, L.rms_norm(x, bp.ln_x), zeros, rope_theta=None,
                                cross_kv=(cache.cross_k[i], cache.cross_v[i]), causal=False)
        x = x + h
        x = x + _mlp(bp, x)
    h = L.rms_norm(x, params.final_norm)
    logits = (h @ params.embed.T).to(torch.float32)
    kv = attn.KVCache(cache.kv.k, cache.kv.v, torch.stack(lengths))
    return DecodeCache(kv, cache.cross_k, cache.cross_v), logits

"""Dense decoder-only transformer (llama3 / gemma2 / the internvl2 LM);
the full-sequence (train, prefill) and decode paths of
``repro.models.transformer``.

Per-layer parameters are stacked along a leading layer axis, as in the
reference; :func:`forward` and :func:`decode_step` loop over the layers in
Python where the reference scans, and with ``cfg.remat`` :func:`forward`
checkpoints every block (non-reentrant ``torch.utils.checkpoint``, the
reference's per-layer ``jax.checkpoint``).  Handles GQA with optional
qk-norm and RoPE, gemma2's extras (attention and logit soft-caps,
sandwich post-norms, sqrt(d) embedding scaling, alternating local /
global windows), and the VLM's visual patch embeddings written over the
first ``n_visual_tokens`` positions, masked out of the loss.

Routing of the attention (``models/attention.decode_step``): a layer
without ``attn_softcap`` runs the ``swa_decode`` kernel on the card, with
its window (a "global" layer's is 2^30, causal attention over the whole
cache); gemma2's soft-capped layers take the plain masked softmax.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L

GLOBAL_WINDOW = 2 ** 30   # the window of a "global" layer


class BlockParams(NamedTuple):
    ln1: torch.Tensor
    attn: attn.AttnParams
    post_attn: torch.Tensor | None
    ln2: torch.Tensor
    w_gate: torch.Tensor
    w_up: torch.Tensor
    w_down: torch.Tensor
    post_mlp: torch.Tensor | None


class Params(NamedTuple):
    embed: torch.Tensor
    blocks: BlockParams              # leaves stacked (n_layers, ...)
    final_norm: torch.Tensor
    unembed: torch.Tensor | None     # None when tied


def layer_windows(cfg: ModelConfig, long_context: bool = False) -> tuple[int, ...]:
    """Per-layer attention window; "global" layers get a huge window."""
    if cfg.sliding_window is None:
        return (GLOBAL_WINDOW,) * cfg.n_layers
    if long_context:
        # Long-context serving mode: every layer windowed (sub-quadratic).
        return (cfg.long_context_window,) * cfg.n_layers
    period = cfg.local_global_period
    return tuple(
        GLOBAL_WINDOW if period > 0 and i % period == period - 1 else cfg.sliding_window
        for i in range(cfg.n_layers)
    )


def _init_block(g: torch.Generator, cfg: ModelConfig) -> BlockParams:
    d, ff = cfg.d_model, cfg.d_ff

    def norm():
        return torch.zeros((d,), dtype=cfg.dtype, device=g.device)

    return BlockParams(
        ln1=norm(),
        attn=attn.init(g, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.qk_norm, cfg.dtype),
        post_attn=norm() if cfg.post_norms else None,
        ln2=norm(),
        w_gate=L.dense_init(g, (d, ff), cfg.dtype),
        w_up=L.dense_init(g, (d, ff), cfg.dtype),
        w_down=L.dense_init(g, (ff, d), cfg.dtype),
        post_mlp=norm() if cfg.post_norms else None,
    )


def init(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """Random params with the reference's distributions and dtypes, drawn
    on the generator's device."""
    embed = L.embed_init(generator, cfg.vocab_size, cfg.d_model, cfg.dtype)
    blocks = L.stack_layers(lambda: _init_block(generator, cfg), cfg.n_layers)
    return Params(
        embed=embed,
        blocks=blocks,
        final_norm=torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=generator.device),
        unembed=None if cfg.tie_embeddings
        else L.dense_init(generator, (cfg.d_model, cfg.vocab_size), cfg.dtype),
    )


def axes(cfg: ModelConfig) -> Params:
    """Logical sharding axes, the structure of :class:`Params`."""
    return Params(
        embed=("vocab", "embed"),
        blocks=BlockParams(
            ln1=("layers", "embed"),
            attn=attn.layer_axes(cfg.qk_norm),
            post_attn=("layers", "embed") if cfg.post_norms else None,
            ln2=("layers", "embed"),
            w_gate=("layers", "embed", "ff"),
            w_up=("layers", "embed", "ff"),
            w_down=("layers", "ff", "embed"),
            post_mlp=("layers", "embed") if cfg.post_norms else None,
        ),
        final_norm=("embed",),
        unembed=None if cfg.tie_embeddings else ("embed", "vocab"),
    )


def from_numpy(tree, device: torch.device | str | None = None) -> Params:
    """The reference's ``Params`` with numpy leaves (``jax.tree.map(
    np.asarray, params)``) -> the port's on ``device``, bit for bit."""
    dev = _device.resolve(device)

    def t(a):
        return None if a is None else L.tensor_from_array(a, dev)

    b = tree.blocks
    blocks = BlockParams(
        ln1=t(b.ln1), attn=attn.AttnParams(*(t(a) for a in b.attn)),
        post_attn=t(b.post_attn), ln2=t(b.ln2), w_gate=t(b.w_gate), w_up=t(b.w_up),
        w_down=t(b.w_down), post_mlp=t(b.post_mlp),
    )
    return Params(embed=t(tree.embed), blocks=blocks, final_norm=t(tree.final_norm),
                  unembed=t(tree.unembed))


def to_numpy(params: Params) -> Params:
    """The inverse of :func:`from_numpy`: host numpy leaves (bf16 as f32)."""
    return L.map_leaves(L.array_from_tensor, params)


def _block_apply(cfg: ModelConfig, bp: BlockParams, window: int, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    h = attn.full_attention(
        bp.attn, L.rms_norm(x, bp.ln1), positions, window=window,
        attn_softcap=cfg.attn_softcap, rope_theta=cfg.rope_theta,
    )
    if bp.post_attn is not None:
        h = L.rms_norm(h, bp.post_attn)
    x = x + h
    h = L.swiglu(L.rms_norm(x, bp.ln2), bp.w_gate, bp.w_up, bp.w_down,
                 act=L.gelu if cfg.post_norms else F.silu)
    if bp.post_mlp is not None:
        h = L.rms_norm(h, bp.post_mlp)
    return x + h


def _embed_inputs(cfg: ModelConfig, params: Params, batch: dict) -> torch.Tensor:
    x = params.embed[batch["tokens"]]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if cfg.n_visual_tokens > 0 and "visual_embeds" in batch:
        vis = batch["visual_embeds"].to(x.dtype)
        x = torch.cat([vis, x[:, vis.shape[1]:]], dim=1)
    return x


def forward(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Hidden states after the final norm: (b, s, d).  ``batch["tokens"]``
    (b, s) int; a VLM's ``batch["visual_embeds"]`` (b, nv, d) replace the
    first nv positions' embeddings."""
    x = _embed_inputs(cfg, params, batch)
    b, s = batch["tokens"].shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    for bp, window in zip(L.unstack_layers(params.blocks, cfg.n_layers), layer_windows(cfg)):
        # The reference pins the residual stream to batch sharding at
        # every layer boundary.
        x = L.shard_hint(x, ("batch", None, None))
        if cfg.remat:
            x = checkpoint(_block_apply, cfg, bp, window, x, positions, use_reentrant=False)
        else:
            x = _block_apply(cfg, bp, window, x, positions)
    return L.rms_norm(x, params.final_norm)


def loss(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy, f32 scalar (text positions only for a
    VLM: targets before position ``n_visual_tokens`` are masked)."""
    h = forward(params, batch, cfg)
    b, s, d = h.shape
    unembed = params.unembed if params.unembed is not None else params.embed.T
    targets = batch["tokens"][:, 1:]
    mask = torch.ones((b, s - 1), dtype=torch.float32, device=h.device)
    if cfg.n_visual_tokens > 0:
        pos = torch.arange(s - 1, device=h.device)[None, :]
        mask = (pos >= cfg.n_visual_tokens).to(torch.float32) * mask
    return L.chunked_cross_entropy(
        h[:, :-1].reshape(-1, d), unembed, targets.reshape(-1), mask.reshape(-1),
        n_chunks=cfg.loss_chunks, softcap_value=cfg.logit_softcap,
    )


class DecodeCache(NamedTuple):
    kv: attn.KVCache        # leaves stacked (n_layers, ...)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, long_context: bool = False,
               device: torch.device | str | None = None) -> DecodeCache:
    """Zero caches, one per layer, stacked; with ``long_context`` only
    ``min(max_seq, long_context_window)`` positions."""
    if long_context:
        max_seq = min(max_seq, cfg.long_context_window)
    return DecodeCache(kv=attn.init_layer_caches(cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
                                                 cfg.head_dim, cfg.dtype, device))


def cache_axes(cfg: ModelConfig) -> DecodeCache:
    """Logical sharding axes of :class:`DecodeCache`."""
    kv = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
    return DecodeCache(kv=attn.KVCache(k=kv, v=kv, length=("layers", "batch")))


def decode_step(
    params: Params,
    cache: DecodeCache,
    tokens: torch.Tensor,         # (b, 1) int
    cfg: ModelConfig,
    long_context: bool = False,
) -> tuple[DecodeCache, torch.Tensor]:
    """Serve one token for the whole batch; returns (cache, logits (b, 1,
    vocab) f32).  Each layer's K/V is written in place into its slice of
    the stacked cache."""
    x = params.embed[tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    act = L.gelu if cfg.post_norms else F.silu
    lengths = []
    for i, window in enumerate(layer_windows(cfg, long_context=long_context)):
        bp = L.layer_slice(params.blocks, i)
        kv = attn.KVCache(cache.kv.k[i], cache.kv.v[i], cache.kv.length[i])
        kv, h = attn.decode_step(
            bp.attn, kv, L.rms_norm(x, bp.ln1), window=window,
            attn_softcap=cfg.attn_softcap, rope_theta=cfg.rope_theta,
        )
        lengths.append(kv.length)
        if bp.post_attn is not None:
            h = L.rms_norm(h, bp.post_attn)
        x = x + h
        h = L.swiglu(L.rms_norm(x, bp.ln2), bp.w_gate, bp.w_up, bp.w_down, act=act)
        if bp.post_mlp is not None:
            h = L.rms_norm(h, bp.post_mlp)
        x = x + h
    h = L.rms_norm(x, params.final_norm)
    unembed = params.unembed if params.unembed is not None else params.embed.T
    logits = (h @ unembed).to(torch.float32)
    if cfg.logit_softcap is not None:
        logits = L.softcap(logits, cfg.logit_softcap)
    return DecodeCache(kv=attn.KVCache(cache.kv.k, cache.kv.v, torch.stack(lengths))), logits

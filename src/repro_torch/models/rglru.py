"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks + local MQA
attention in a (rec, rec, attn) pattern (arXiv:2402.19427); the
full-sequence (train, prefill) and decode paths of ``repro.models.rglru``.

Every temporal-mixing block is followed by a gated-MLP.  The RG-LRU
recurrence

    r_t = sigmoid(W_r x + b_r);  i_t = sigmoid(W_i x + b_i)
    log a_t = -c * softplus(lambda) * r_t
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

runs over the sequence as a log-depth scan (:func:`_rglru_scan`, where
the reference calls ``jax.lax.associative_scan``) and as one update per
decode step.  Layers are a Python loop (heterogeneous structure); with
``cfg.remat`` :func:`forward` checkpoints every temporal block and every
MLP, as the reference does.  The attention layers
have a window and no soft-cap, so on the card each runs the
``swa_decode`` kernel (``models/attention.decode_step``'s routing).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L


class RecParams(NamedTuple):
    ln: torch.Tensor
    w_x: torch.Tensor        # (d, r) linear branch into the recurrence
    w_gate: torch.Tensor     # (d, r) gelu gate branch
    conv_w: torch.Tensor     # (width, r) depthwise temporal conv
    conv_b: torch.Tensor
    w_rg: torch.Tensor       # (r, r) recurrence gate
    b_rg: torch.Tensor       # f32
    w_ig: torch.Tensor       # (r, r) input gate
    b_ig: torch.Tensor       # f32
    lam: torch.Tensor        # (r,) f32 learnable decay parameter
    w_out: torch.Tensor      # (r, d)


class AttnBlock(NamedTuple):
    ln: torch.Tensor
    attn: attn.AttnParams


class MLPParams(NamedTuple):
    ln: torch.Tensor
    w_gate: torch.Tensor
    w_up: torch.Tensor
    w_down: torch.Tensor


class Params(NamedTuple):
    embed: torch.Tensor
    temporal: tuple[Any, ...]     # RecParams | AttnBlock per layer
    mlps: tuple[MLPParams, ...]
    final_norm: torch.Tensor


def pattern(cfg: ModelConfig) -> tuple[str, ...]:
    base = cfg.block_pattern or ("rec", "rec", "attn")
    return tuple(base[i % len(base)] for i in range(cfg.n_layers))


def _init_rec(g: torch.Generator, cfg: ModelConfig) -> RecParams:
    d = cfg.d_model
    r = d  # lru width = d_model for recurrentgemma-2b
    dev = g.device
    return RecParams(
        ln=torch.zeros((d,), dtype=cfg.dtype, device=dev),
        w_x=L.dense_init(g, (d, r), cfg.dtype),
        w_gate=L.dense_init(g, (d, r), cfg.dtype),
        conv_w=L.dense_init(g, (cfg.conv_width, r), cfg.dtype, scale=cfg.conv_width ** -0.5),
        conv_b=torch.zeros((r,), dtype=cfg.dtype, device=dev),
        w_rg=L.dense_init(g, (r, r), cfg.dtype),
        b_rg=torch.zeros((r,), dtype=torch.float32, device=dev),
        w_ig=L.dense_init(g, (r, r), cfg.dtype),
        b_ig=torch.zeros((r,), dtype=torch.float32, device=dev),
        # softplus(lam) ~ U[...] so a^c starts in a stable range
        lam=0.3 + 0.5 * torch.rand((r,), generator=g, dtype=torch.float32, device=dev),
        w_out=L.dense_init(g, (r, d), cfg.dtype),
    )


def _init_mlp(g: torch.Generator, cfg: ModelConfig) -> MLPParams:
    d, ff = cfg.d_model, cfg.d_ff
    return MLPParams(
        ln=torch.zeros((d,), dtype=cfg.dtype, device=g.device),
        w_gate=L.dense_init(g, (d, ff), cfg.dtype),
        w_up=L.dense_init(g, (d, ff), cfg.dtype),
        w_down=L.dense_init(g, (ff, d), cfg.dtype),
    )


def init(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """Random params with the reference's distributions and dtypes, drawn
    on the generator's device."""
    embed = L.embed_init(generator, cfg.vocab_size, cfg.d_model, cfg.dtype)
    temporal = tuple(
        _init_rec(generator, cfg) if p == "rec" else AttnBlock(
            ln=torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=generator.device),
            attn=attn.init(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, False, cfg.dtype),
        )
        for p in pattern(cfg)
    )
    mlps = tuple(_init_mlp(generator, cfg) for _ in range(cfg.n_layers))
    return Params(
        embed=embed, temporal=temporal, mlps=mlps,
        final_norm=torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=generator.device),
    )


def axes(cfg: ModelConfig) -> Params:
    """Logical sharding axes, the structure of :class:`Params`."""
    rec_ax = RecParams(
        ln=("embed",), w_x=("embed", "inner"), w_gate=("embed", "inner"),
        conv_w=(None, "inner"), conv_b=("inner",),
        w_rg=("inner", "inner2"), b_rg=("inner",),
        w_ig=("inner", "inner2"), b_ig=("inner",),
        lam=("inner",), w_out=("inner", "embed"),
    )
    attn_ax = AttnBlock(ln=("embed",), attn=attn.axes(False))
    mlp_ax = MLPParams(ln=("embed",), w_gate=("embed", "ff"), w_up=("embed", "ff"),
                       w_down=("ff", "embed"))
    pat = pattern(cfg)
    return Params(
        embed=("vocab", "embed"),
        temporal=tuple(rec_ax if p == "rec" else attn_ax for p in pat),
        mlps=tuple(mlp_ax for _ in pat),
        final_norm=("embed",),
    )


def from_numpy(tree: Any, device: torch.device | str | None = None) -> Params:
    """The reference's ``Params`` with numpy leaves (``jax.tree.map(
    np.asarray, params)``) -> the port's on ``device``, bit for bit."""
    dev = _device.resolve(device)

    def t(a):
        return None if a is None else L.tensor_from_array(a, dev)

    def temporal(tp):
        if "attn" in tp._fields:
            return AttnBlock(t(tp.ln), attn.AttnParams(*(t(a) for a in tp.attn)))
        return RecParams(*(t(a) for a in tp))

    return Params(
        embed=t(tree.embed),
        temporal=tuple(temporal(tp) for tp in tree.temporal),
        mlps=tuple(MLPParams(*(t(a) for a in m)) for m in tree.mlps),
        final_norm=t(tree.final_norm),
    )


def to_numpy(params: Params) -> Params:
    """The inverse of :func:`from_numpy`: host numpy leaves (bf16 as f32)."""
    return L.map_leaves(L.array_from_tensor, params)


def _mlp_apply(p: MLPParams, x: torch.Tensor) -> torch.Tensor:
    return x + L.swiglu(L.rms_norm(x, p.ln), p.w_gate, p.w_up, p.w_down, act=L.gelu)


def _rglru_scan(a: torch.Tensor, bx: torch.Tensor,
                h0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + bx_t over axis 1; a, bx: (b, l, r).  Returns
    (every h (b, l, r), the last (b, r)).

    An inclusive Hillis-Steele scan of the (a, b) pairs under
    (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2): ceil(log2 l) rounds of one
    shifted multiply-add each, differentiable by autograd.  ``h0`` is
    folded into the first element (b_0 + a_0 h0), as in the reference; the
    association order is not the reference's, so the two agree to
    rounding."""
    if h0 is not None:
        bx = torch.cat([bx[:, :1] + a[:, :1] * h0[:, None], bx[:, 1:]], dim=1)
    shift, length = 1, a.shape[1]
    while shift < length:
        bx = torch.cat([bx[:, :shift], a[:, shift:] * bx[:, :-shift] + bx[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return bx, bx[:, -1]


def _rec_apply(p: RecParams, x: torch.Tensor, cfg: ModelConfig,
               h0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence RG-LRU block, x (b, l, d): (x + block output, the last
    recurrent state (b, r) f32)."""
    u = L.rms_norm(x, p.ln)
    xb = u @ p.w_x
    gate = L.gelu(u @ p.w_gate)
    # Temporal conv (causal, depthwise).
    width, length = p.conv_w.shape[0], xb.shape[1]
    pad = F.pad(xb, (0, 0, width - 1, 0))
    xb = sum(pad[:, i:i + length, :] * p.conv_w[i] for i in range(width)) + p.conv_b
    # The reference anchors the square gate maps' outputs to the inner
    # shard (a reduce-scatter instead of a replicated all-reduce).
    r = torch.sigmoid(L.shard_hint((xb @ p.w_rg).to(torch.float32), ("batch", None, "inner"))
                      + p.b_rg)
    i = torch.sigmoid(L.shard_hint((xb @ p.w_ig).to(torch.float32), ("batch", None, "inner"))
                      + p.b_ig)
    a = torch.exp(-cfg.rglru_c * L.softplus(p.lam) * r)
    scale = torch.sqrt(torch.clamp_min(1.0 - torch.square(a), 1e-6))
    h, hlast = _rglru_scan(a, scale * (i * xb.to(torch.float32)), h0)
    y = h.to(x.dtype) * gate
    return x + y @ p.w_out, hlast


def _rec_block(cfg: ModelConfig, tp: RecParams, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    return _rec_apply(tp, x, cfg)[0]


def _attn_block(cfg: ModelConfig, tp: AttnBlock, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    return x + attn.full_attention(tp.attn, L.rms_norm(x, tp.ln), positions,
                                   window=cfg.sliding_window, rope_theta=cfg.rope_theta)


def forward(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Hidden states after the final norm: (b, s, d)."""
    x = params.embed[batch["tokens"]]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    b, s = batch["tokens"].shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    for tp, mp in zip(params.temporal, params.mlps):
        block = _rec_block if isinstance(tp, RecParams) else _attn_block
        if cfg.remat:
            x = checkpoint(block, cfg, tp, x, positions, use_reentrant=False)
            x = checkpoint(_mlp_apply, mp, x, use_reentrant=False)
        else:
            x = _mlp_apply(mp, block(cfg, tp, x, positions))
    return L.rms_norm(x, params.final_norm)


def loss(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy through the tied embedding, f32 scalar."""
    h = forward(params, batch, cfg)
    b, s, d = h.shape
    return L.chunked_cross_entropy(
        h[:, :-1].reshape(-1, d), params.embed.T, batch["tokens"][:, 1:].reshape(-1),
        torch.ones((b * (s - 1),), dtype=torch.float32, device=h.device),
        n_chunks=cfg.loss_chunks, softcap_value=cfg.logit_softcap,
    )


class DecodeCache(NamedTuple):
    kv: tuple[attn.KVCache, ...]         # per-attn-layer KVCache
    rec_h: tuple[torch.Tensor, ...]      # per-rec-layer (b, r) f32 hidden states
    rec_conv: tuple[torch.Tensor, ...]   # per-rec-layer (b, width-1, r)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, long_context: bool = False,
               device: torch.device | str | None = None) -> DecodeCache:
    """Zero caches; with ``long_context`` the KV caches hold only
    ``min(max_seq, window)`` positions (writes past it clamp to the last
    slot, as in the reference)."""
    dev = _device.resolve(device)
    window = cfg.sliding_window or 2048
    cache_seq = min(max_seq, window) if long_context else max_seq
    kv, rec_h, rec_conv = [], [], []
    r = cfg.d_model
    for p in pattern(cfg):
        if p == "attn":
            kv.append(attn.init_cache(batch, cache_seq, cfg.n_kv_heads, cfg.head_dim,
                                      cfg.dtype, dev))
        else:
            rec_h.append(torch.zeros((batch, r), dtype=torch.float32, device=dev))
            rec_conv.append(torch.zeros((batch, cfg.conv_width - 1, r), dtype=cfg.dtype,
                                        device=dev))
    return DecodeCache(kv=tuple(kv), rec_h=tuple(rec_h), rec_conv=tuple(rec_conv))


def decode_step(
    params: Params,
    cache: DecodeCache,
    tokens: torch.Tensor,         # (b, 1) int
    cfg: ModelConfig,
    long_context: bool = False,
) -> tuple[DecodeCache, torch.Tensor]:
    """Serve one token for the whole batch: (cache, logits (b, 1, vocab)
    f32).  The KV caches are written in place (``attention.decode_step``)."""
    del long_context  # the cache's own size decides
    x = params.embed[tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    new_kv, new_h, new_conv = [], [], []
    i_kv = i_rec = 0
    for tp, mp in zip(params.temporal, params.mlps):
        if isinstance(tp, RecParams):
            res = x
            u = L.rms_norm(x, tp.ln)[:, 0]
            xb = u @ tp.w_x
            gate = L.gelu(u @ tp.w_gate)
            hist = torch.cat([cache.rec_conv[i_rec], xb[:, None, :]], dim=1)
            xb = torch.einsum("bwr,wr->br", hist, tp.conv_w) + tp.conv_b
            new_conv.append(hist[:, 1:, :])
            r_g = torch.sigmoid((xb @ tp.w_rg).to(torch.float32) + tp.b_rg)
            i_g = torch.sigmoid((xb @ tp.w_ig).to(torch.float32) + tp.b_ig)
            a = torch.exp(-cfg.rglru_c * L.softplus(tp.lam) * r_g)
            scale = torch.sqrt(torch.clamp_min(1.0 - torch.square(a), 1e-6))
            h = a * cache.rec_h[i_rec] + scale * (i_g * xb.to(torch.float32))
            new_h.append(h)
            y = h.to(x.dtype) * gate
            x = res + (y @ tp.w_out)[:, None, :]
            i_rec += 1
        else:
            kv, h = attn.decode_step(
                tp.attn, cache.kv[i_kv], L.rms_norm(x, tp.ln),
                window=cfg.sliding_window, rope_theta=cfg.rope_theta,
            )
            new_kv.append(kv)
            x = x + h
            i_kv += 1
        x = _mlp_apply(mp, x)
    h = L.rms_norm(x, params.final_norm)
    logits = (h @ params.embed.T).to(torch.float32)
    if cfg.logit_softcap is not None:
        logits = L.softcap(logits, cfg.logit_softcap)
    return (
        DecodeCache(kv=tuple(new_kv), rec_h=tuple(new_h), rec_conv=tuple(new_conv)),
        logits,
    )

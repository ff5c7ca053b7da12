"""Mamba-2 (SSD, state-space duality) decoder, attention-free; the
full-sequence (train, prefill) and decode paths of ``repro.models.ssm``.

Training and prefill use the chunked SSD algorithm (Dao & Gu, 2024):
quadratic attention-like compute within chunks of ``cfg.ssm_chunk``
steps, a linear recurrence across the chunk states (a Python loop over the
chunks where the reference scans), never the (L x L) kernel.  Decode is
the O(1) recurrent update of the (H, N, P) state, written into the cache
in place as the attention families write their K/V.

``a_log``, ``d_skip`` and ``dt_bias`` are f32 leaves in a bf16 model, as in
the reference; the recurrence runs in f32.  Per-layer parameters are
stacked along a leading layer axis; with ``cfg.remat`` every block is
checkpointed.  No Pallas kernel backs this family in the reference: its
port is plain PyTorch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


class BlockParams(NamedTuple):
    ln: torch.Tensor          # (d,)
    in_proj: torch.Tensor     # (d, 2*d_in + 2*N + H)
    conv_w: torch.Tensor      # (width, d_in + 2*N) depthwise
    conv_b: torch.Tensor      # (d_in + 2*N,)
    a_log: torch.Tensor       # (H,) f32
    d_skip: torch.Tensor      # (H,) f32
    dt_bias: torch.Tensor     # (H,) f32
    gate_norm: torch.Tensor   # (d_in,)
    out_proj: torch.Tensor    # (d_in, d)


class Params(NamedTuple):
    embed: torch.Tensor
    blocks: BlockParams       # leaves stacked (n_layers, ...)
    final_norm: torch.Tensor


def dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    """(d_inner, n_heads, head_dim P, state N)."""
    d_in = cfg.ssm_expand * cfg.d_model
    p = cfg.ssm_head_dim
    return d_in, d_in // p, p, cfg.ssm_state


def _uniform(g: torch.Generator, shape: tuple[int, ...], lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=g, dtype=torch.float32, device=g.device)
    return lo + (hi - lo) * u


def _init_block(g: torch.Generator, cfg: ModelConfig) -> BlockParams:
    d = cfg.d_model
    d_in, h, _, n = dims(cfg)
    ch = d_in + 2 * n
    dev = g.device
    return BlockParams(
        ln=torch.zeros((d,), dtype=cfg.dtype, device=dev),
        in_proj=L.dense_init(g, (d, 2 * d_in + 2 * n + h), cfg.dtype),
        conv_w=L.dense_init(g, (cfg.conv_width, ch), cfg.dtype, scale=cfg.conv_width ** -0.5),
        conv_b=torch.zeros((ch,), dtype=cfg.dtype, device=dev),
        a_log=torch.log(_uniform(g, (h,), 1.0, 16.0)),
        d_skip=torch.ones((h,), dtype=torch.float32, device=dev),
        dt_bias=torch.log(torch.exp(_uniform(g, (h,), 1e-3, 0.1)) - 1.0),
        gate_norm=torch.zeros((d_in,), dtype=cfg.dtype, device=dev),
        out_proj=L.dense_init(g, (d_in, d), cfg.dtype),
    )


def init(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """Random params with the reference's distributions and dtypes, drawn
    on the generator's device."""
    embed = L.embed_init(generator, cfg.vocab_size, cfg.d_model, cfg.dtype)
    return Params(
        embed=embed,
        blocks=L.stack_layers(lambda: _init_block(generator, cfg), cfg.n_layers),
        final_norm=torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=generator.device),
    )


def axes(cfg: ModelConfig) -> Params:
    """Logical sharding axes, the structure of :class:`Params`."""
    return Params(
        embed=("vocab", "embed"),
        blocks=BlockParams(
            ln=("layers", "embed"),
            in_proj=("layers", "embed", "inner_proj"),
            conv_w=("layers", None, "inner_conv"),
            conv_b=("layers", "inner_conv"),
            a_log=("layers", "ssm_heads"),
            d_skip=("layers", "ssm_heads"),
            dt_bias=("layers", "ssm_heads"),
            gate_norm=("layers", "inner"),
            out_proj=("layers", "inner", "embed"),
        ),
        final_norm=("embed",),
    )


def from_numpy(tree, device: torch.device | str | None = None) -> Params:
    """The reference's ``Params`` with numpy leaves (``jax.tree.map(
    np.asarray, params)``) -> the port's on ``device``, bit for bit."""
    dev = _device.resolve(device)
    return Params(embed=L.tensor_from_array(tree.embed, dev),
                  blocks=BlockParams(*(L.tensor_from_array(a, dev) for a in tree.blocks)),
                  final_norm=L.tensor_from_array(tree.final_norm, dev))


def to_numpy(params: Params) -> Params:
    """The inverse of :func:`from_numpy`: host numpy leaves (bf16 as f32)."""
    return L.map_leaves(L.array_from_tensor, params)


def _split_proj(z_xbc_dt: torch.Tensor, cfg: ModelConfig):
    d_in, _, _, n = dims(cfg)
    z = z_xbc_dt[..., :d_in]
    xbc = z_xbc_dt[..., d_in:2 * d_in + 2 * n]
    dt = z_xbc_dt[..., 2 * d_in + 2 * n:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (b, l, ch) with (width, ch) weights: the
    taps added from zero in the reference's order, in xbc's dtype."""
    width, length = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(width):
        out = out + pad[:, i:i + length, :] * w[i]
    return F.silu(out + b)


def ssd_chunked(
    x: torch.Tensor,      # (b, l, h, p)
    dt: torch.Tensor,     # (b, l, h) post-softplus
    a: torch.Tensor,      # (h,) negative
    bmat: torch.Tensor,   # (b, l, n)
    cmat: torch.Tensor,   # (b, l, n)
    chunk: int,
    h0: torch.Tensor | None = None,   # (b, h, n, p) initial state
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  Returns (y (b, l, h, p), final state (b, h, n, p)).

    The reference's three-operand contractions are taken two operands at a
    time, the smaller factor folded in first: ``dt`` into the (b, nc, q, q,
    h) decay matrix before it meets x, so no (b, nc, q, q, h, p) product is
    made.  The decay's upper triangle is masked before its ``exp`` (the
    reference masks after), which gives the same zeros and keeps an
    overflowing exponent there out of the gradient."""
    b, sl, h, p = x.shape
    n = bmat.shape[-1]
    if sl % chunk:
        raise ValueError(f"sequence length {sl} is not a multiple of the SSD chunk {chunk}")
    nc, q = sl // chunk, chunk

    xr = x.reshape(b, nc, q, h, p)
    dtr = dt.reshape(b, nc, q, h)
    br = bmat.reshape(b, nc, q, n)
    cr = cmat.reshape(b, nc, q, n)

    cum = torch.cumsum(dtr * a, dim=2)                          # (b, nc, q, h) log-decay

    # Intra-chunk (quadratic within the chunk).
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # (b, nc, q_i, q_j, h)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(causal[None, None, :, :, None], li, -torch.inf))
    scores = torch.einsum("bcin,bcjn->bcij", cr, br)            # (b, nc, q, q)
    m = scores[..., None] * decay * dtr[:, :, None, :, :]       # (b, nc, q_i, q_j, h)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, xr)

    # Chunk summary states.
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)           # (b, nc, q, h)
    s_chunk = torch.einsum("bcqn,bcqhp->bchnp", br, (decay_to_end * dtr)[..., None] * xr)

    # Inter-chunk linear recurrence over the chunk states, each chunk's
    # start state kept.
    g = torch.exp(cum[:, :, -1, :])                             # (b, nc, h)
    hprev = torch.zeros((b, h, n, p), dtype=x.dtype, device=x.device) if h0 is None else h0
    starts = []
    for c in range(nc):
        starts.append(hprev)
        hprev = g[:, c, :, None, None] * hprev + s_chunk[:, c]
    hstart = torch.stack(starts, dim=1)                         # (b, nc, h, n, p)

    y_inter = torch.einsum("bcin,bchnp->bcihp", cr, hstart) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, sl, h, p)
    return y, hprev


def _block_apply(cfg: ModelConfig, bp: BlockParams, x: torch.Tensor) -> torch.Tensor:
    d_in, h, p, n = dims(cfg)
    b, length = x.shape[:2]
    u = L.rms_norm(x, bp.ln)
    z, xbc, dt = _split_proj(u @ bp.in_proj, cfg)
    xbc = _causal_conv(xbc, bp.conv_w, bp.conv_b)
    xs = xbc[..., :d_in].reshape(b, length, h, p).to(torch.float32)
    bmat = xbc[..., d_in:d_in + n].to(torch.float32)
    cmat = xbc[..., d_in + n:].to(torch.float32)
    dt = L.softplus(dt.to(torch.float32) + bp.dt_bias)
    a = -torch.exp(bp.a_log)
    y, _ = ssd_chunked(xs, dt, a, bmat, cmat, cfg.ssm_chunk)
    y = y + bp.d_skip[None, None, :, None] * xs
    y = y.reshape(b, length, d_in).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), bp.gate_norm)
    return x + y @ bp.out_proj


def forward(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Hidden states after the final norm: (b, s, d); s must be a multiple
    of ``cfg.ssm_chunk``."""
    x = params.embed[batch["tokens"]]
    for bp in L.unstack_layers(params.blocks, cfg.n_layers):
        if cfg.remat:
            x = checkpoint(_block_apply, cfg, bp, x, use_reentrant=False)
        else:
            x = _block_apply(cfg, bp, x)
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
    ssm_state: torch.Tensor    # (layers, b, h, n, p) f32
    conv_state: torch.Tensor   # (layers, b, width-1, d_in + 2n) cfg.dtype
    length: torch.Tensor       # (b,) int32


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, long_context: bool = False,
               device: torch.device | str | None = None) -> DecodeCache:
    """Zero states, O(1) in ``max_seq``; ``device=None`` means the card."""
    del max_seq, long_context
    dev = _device.resolve(device)
    d_in, h, p, n = dims(cfg)
    return DecodeCache(
        ssm_state=torch.zeros((cfg.n_layers, batch, h, n, p), dtype=torch.float32, device=dev),
        conv_state=torch.zeros((cfg.n_layers, batch, cfg.conv_width - 1, d_in + 2 * n),
                               dtype=cfg.dtype, device=dev),
        length=torch.zeros((batch,), dtype=torch.int32, device=dev),
    )


def cache_axes(cfg: ModelConfig) -> DecodeCache:
    """Logical sharding axes of :class:`DecodeCache`."""
    return DecodeCache(
        ssm_state=("layers", "batch", "ssm_heads", None, None),
        conv_state=("layers", "batch", None, "inner_conv"),
        length=("batch",),
    )


def decode_step(params: Params, cache: DecodeCache, tokens: torch.Tensor, cfg: ModelConfig,
                long_context: bool = False) -> tuple[DecodeCache, torch.Tensor]:
    """Serve one token for the whole batch: the recurrent update of every
    layer's state (written into the cache's tensors in place); returns
    (cache, logits (b, 1, vocab) f32)."""
    del long_context
    d_in, h, p, n = dims(cfg)
    x = params.embed[tokens][:, 0]                              # (b, d)
    for i in range(cfg.n_layers):
        bp = L.layer_slice(params.blocks, i)
        u = L.rms_norm(x, bp.ln)
        z, xbc, dt = _split_proj(u @ bp.in_proj, cfg)
        # Depthwise causal conv from the rolling buffer.
        hist = torch.cat([cache.conv_state[i], xbc[:, None, :]], dim=1)   # (b, w, ch)
        conv = F.silu(torch.einsum("bwc,wc->bc", hist, bp.conv_w) + bp.conv_b)
        cache.conv_state[i].copy_(hist[:, 1:, :])
        xs = conv[:, :d_in].reshape(-1, h, p).to(torch.float32)
        bmat = conv[:, d_in:d_in + n].to(torch.float32)
        cmat = conv[:, d_in + n:].to(torch.float32)
        dt1 = L.softplus(dt.to(torch.float32) + bp.dt_bias)                # (b, h)
        decay = torch.exp(dt1 * -torch.exp(bp.a_log))
        upd = dt1[:, :, None, None] * bmat[:, None, :, None] * xs[:, :, None, :]
        hnew = decay[:, :, None, None] * cache.ssm_state[i] + upd
        cache.ssm_state[i].copy_(hnew)
        y = torch.einsum("bn,bhnp->bhp", cmat, hnew)
        y = y + bp.d_skip[None, :, None] * xs
        y = y.reshape(-1, d_in).to(x.dtype)
        y = L.rms_norm(y * F.silu(z), bp.gate_norm)
        x = x + y @ bp.out_proj
    hfinal = L.rms_norm(x, params.final_norm)
    logits = (hfinal @ params.embed.T).to(torch.float32)
    return (DecodeCache(cache.ssm_state, cache.conv_state, cache.length + 1),
            logits[:, None, :])

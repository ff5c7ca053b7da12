"""Attention for the language models: GQA with optional qk-norm,
soft-capping and sliding-window masking; the full-sequence (train and
prefill) and single-token decode paths of ``repro.models.attention``.

Shapes follow the (batch, seq, heads, head_dim) convention; KV caches are
(batch, max_seq, kv_heads, head_dim).  Unlike the reference, which updates
the cache functionally, :func:`decode_step` writes the new K/V into the
cache tensors in place (a decode step would otherwise copy every cache of
the model) and returns a :class:`KVCache` holding those tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import device as _device
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L

NEG_INF = -2.3819763e38  # the reference's mask value of the plain branch


class AttnParams(NamedTuple):
    wq: torch.Tensor        # (d_model, n_heads, head_dim)
    wk: torch.Tensor        # (d_model, n_kv, head_dim)
    wv: torch.Tensor        # (d_model, n_kv, head_dim)
    wo: torch.Tensor        # (n_heads, head_dim, d_model)
    q_norm: torch.Tensor | None    # (head_dim,) qk-norm scales (qwen3)
    k_norm: torch.Tensor | None


def init(
    generator: torch.Generator,
    d_model: int,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    qk_norm: bool = False,
    dtype: torch.dtype = torch.bfloat16,
) -> AttnParams:
    dev = generator.device
    return AttnParams(
        wq=L.dense_init(generator, (d_model, n_heads, head_dim), dtype),
        wk=L.dense_init(generator, (d_model, n_kv, head_dim), dtype),
        wv=L.dense_init(generator, (d_model, n_kv, head_dim), dtype),
        wo=L.dense_init(generator, (n_heads, head_dim, d_model), dtype,
                        scale=(n_heads * head_dim) ** -0.5),
        q_norm=torch.zeros((head_dim,), dtype=dtype, device=dev) if qk_norm else None,
        k_norm=torch.zeros((head_dim,), dtype=dtype, device=dev) if qk_norm else None,
    )


def axes(qk_norm: bool = False) -> AttnParams:
    """Logical sharding axes matching :class:`AttnParams` (tuples of logical
    dimension names, ``None`` for an absent leaf; ``launch/sharding``)."""
    return AttnParams(
        wq=("embed", "heads", "head_dim"),
        wk=("embed", "kv_heads", "head_dim"),
        wv=("embed", "kv_heads", "head_dim"),
        wo=("heads", "head_dim", "embed"),
        q_norm=("head_dim",) if qk_norm else None,
        k_norm=("head_dim",) if qk_norm else None,
    )


def layer_axes(qk_norm: bool = False) -> AttnParams:
    """:func:`axes` with a leading ``"layers"`` axis, for stacked blocks."""
    return AttnParams(*(None if a is None else ("layers",) + a for a in axes(qk_norm)))


def _project_qkv(
    p: AttnParams, x: torch.Tensor, positions: torch.Tensor,
    rope_theta: float | None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv)
    if p.q_norm is not None:
        q = L.rms_norm(q, p.q_norm)
        k = L.rms_norm(k, p.k_norm)
    if rope_theta is not None:  # None => absolute-position models (whisper)
        q = L.apply_rope(q, positions, rope_theta)
        k = L.apply_rope(k, positions, rope_theta)
    # The reference's activation anchors after rope: heads when divisible,
    # else the query sequence; head_dim is deliberately not offered.
    q = L.shard_hint(q, ("batch", "seq_shard", "heads", None))
    k = L.shard_hint(k, ("batch", None, "kv_heads", None))
    v = L.shard_hint(v, ("batch", None, "kv_heads", None))
    return q, k, v


def full_attention(
    p: AttnParams,
    x: torch.Tensor,              # (b, s, d)
    positions: torch.Tensor,      # (b, s)
    window: int | None = None,    # sliding window (tokens) or None
    attn_softcap: float | None = None,
    rope_theta: float = 10000.0,
    cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
    causal: bool = True,
) -> torch.Tensor:
    """Dense masked attention over the whole sequence (train / prefill):
    (b, s, d) in x's dtype.  Scores in f32 (the product of the f32
    upcasts), soft-capped, masked with ``NEG_INF`` outside the causal
    window (key positions t with q - window < t <= q), softmax in f32 cast
    back to x's dtype before the PV product, as in the reference.  Plain
    PyTorch, as the reference's plain ``jnp`` is.

    ``cross_kv = (k, v)``, each (b, t, n_kv, head_dim), is the enc-dec
    family's cross-attention: q alone is projected (with its q-norm when
    there is one), k and v are taken as they are (no rope), and neither
    the causal nor the window mask applies."""
    b, s, _ = x.shape
    if cross_kv is None:
        q, k, v = _project_qkv(p, x, positions, rope_theta)
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p.wq)
        if p.q_norm is not None:
            q = L.rms_norm(q, p.q_norm)
        k, v = cross_kv
    n_heads, head_dim = q.shape[-2], q.shape[-1]
    n_kv = k.shape[-2]
    g = n_heads // n_kv

    qg = q.reshape(b, s, n_kv, g, head_dim)
    scores = torch.einsum(
        "bqhgd,bthd->bhgqt", qg.to(torch.float32), k.to(torch.float32)
    ) * (head_dim ** -0.5)                          # (b, n_kv, g, s_q, s_k)
    if attn_softcap is not None:
        scores = L.softcap(scores, attn_softcap)
    qpos = positions[:, :, None]                    # (b, s_q, 1)
    kpos = torch.arange(k.shape[1], device=x.device)[None, None, :]
    mask = torch.ones((b, s, k.shape[1]), dtype=torch.bool, device=x.device)
    if causal and cross_kv is None:
        mask &= kpos <= qpos
    if window is not None and cross_kv is None:
        mask &= kpos > qpos - window
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhgqt,bthk->bqhgk", probs, v)
    out = out.reshape(b, s, n_heads, head_dim)
    return torch.einsum("bshk,hkd->bsd", out, p.wo)


class KVCache(NamedTuple):
    k: torch.Tensor          # (b, max_seq, n_kv, head_dim)
    v: torch.Tensor
    length: torch.Tensor     # (b,) int32 — tokens seen (may pass max_seq)


def init_cache(
    batch: int, max_seq: int, n_kv: int, head_dim: int,
    dtype: torch.dtype = torch.bfloat16, device: torch.device | str | None = None,
) -> KVCache:
    """Zero caches; ``device=None`` means the card."""
    device = _device.resolve(device)
    return KVCache(
        k=torch.zeros((batch, max_seq, n_kv, head_dim), dtype=dtype, device=device),
        v=torch.zeros((batch, max_seq, n_kv, head_dim), dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def init_layer_caches(
    n_layers: int, batch: int, max_seq: int, n_kv: int, head_dim: int,
    dtype: torch.dtype = torch.bfloat16, device: torch.device | str | None = None,
) -> KVCache:
    """``n_layers`` zero caches stacked along a leading layer axis, as the
    reference broadcasts ``init_cache`` over a model's layers; ``device=None``
    means the card."""
    device = _device.resolve(device)
    shape = (n_layers, batch, max_seq, n_kv, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((n_layers, batch), dtype=torch.int32, device=device),
    )


def decode_step(
    p: AttnParams,
    cache: KVCache,
    x: torch.Tensor,              # (b, 1, d) — the new token's activations
    window: int | None = None,
    attn_softcap: float | None = None,
    rope_theta: float = 10000.0,
) -> tuple[KVCache, torch.Tensor]:
    """One decode step: write the new K/V at ``length`` (in place), attend,
    return (cache, out (b, 1, d)).

    The write clamps its slot to ``max_seq - 1`` as the reference's
    ``dynamic_update_slice`` does, so once ``length >= max_seq`` every new
    token overwrites the last slot while ``length`` keeps growing; rope
    takes the position ``length`` before the increment.

    Routing replaces the reference's ``use_pallas_swa`` flag and is decided
    by the layer alone: a layer with a window and no ``attn_softcap`` goes
    to ``kernels/ops.swa_decode_attention`` (the ``swa_decode`` kernel on
    the card, its plain version on the CPU); any other layer takes the
    plain masked softmax of the reference's other branch (``NEG_INF``
    mask, probabilities cast to x's dtype before the PV product).  The two
    compute the same function except where the window is empty (the
    kernel gives zeros, the plain branch the mean of the whole cache)."""
    b = x.shape[0]
    positions = cache.length[:, None]               # (b, 1)
    q, k_new, v_new = _project_qkv(p, x, positions, rope_theta)

    max_seq = cache.k.shape[1]
    slot = torch.clamp(cache.length, max=max_seq - 1).to(torch.int64)
    rows = torch.arange(b, device=x.device)
    cache.k[rows, slot] = k_new[:, 0]
    cache.v[rows, slot] = v_new[:, 0]
    k, v = cache.k, cache.v
    new_len = cache.length + 1

    n_heads, head_dim = q.shape[-2], q.shape[-1]
    n_kv = k.shape[-2]
    g = n_heads // n_kv

    if window is not None and attn_softcap is None:
        out = kops.swa_decode_attention(q.reshape(b, n_heads, head_dim), k, v, new_len,
                                        int(window))
        out = out.reshape(b, 1, n_heads, head_dim)
    else:
        qg = q.reshape(b, 1, n_kv, g, head_dim)
        scores = torch.einsum(
            "bqhgk,bthk->bhgqt", qg.to(torch.float32), k.to(torch.float32)
        ) * (head_dim ** -0.5)
        if attn_softcap is not None:
            scores = L.softcap(scores, attn_softcap)
        kpos = torch.arange(max_seq, device=x.device)[None, :]
        valid = kpos < new_len[:, None]
        if window is not None:
            valid &= kpos >= (new_len[:, None] - window)
        scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bhgqt,bthk->bqhgk", probs, v)
        out = out.reshape(b, 1, n_heads, head_dim)

    y = torch.einsum("bshk,hkd->bsd", out, p.wo)
    return KVCache(k, v, new_len), y

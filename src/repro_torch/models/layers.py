"""Shared layers of the language models, the decode and training subset
of ``repro.models.layers``.

Plain functions over tensors; the compute dtype is the params' (bf16 for
the published configs) with f32 norms, softmax and logits, as in the
reference.  Initialisers draw
from a ``torch.Generator``, on its device, with the reference's
distributions and dtypes (not its numbers: threefry is not reproduced;
tests carry the reference's own params across with ``from_numpy``).
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import sharding


def shard_hint(x: torch.Tensor, logical: tuple[str | None, ...]) -> torch.Tensor:
    """The reference's activation-sharding anchor: ``x``'s logical
    dimension names resolved against the ambient mesh
    (``launch/sharding.use_mesh``, which the dry run installs) by the
    parameter rules, so a hint that does not fit ``x`` raises as the
    reference's does; the hint is counted on the mesh's scope.  Returns
    ``x`` untouched: PyTorch has no activation-sharding constraint outside
    DTensor, and the models run on plain tensors.  Without an ambient mesh,
    or on a one-device mesh, nothing is resolved."""
    scope = sharding.ambient()
    if scope is None or not scope.mesh.axis_names or scope.mesh.size <= 1:
        return x
    sharding.resolve_spec(logical, tuple(x.shape), scope.mesh)
    scope.hints += 1
    return x


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 scaled by ``1 + scale``, cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 (biased variance), cast back to x's dtype."""
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    out = out * scale.to(torch.float32) + bias.to(torch.float32)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device: torch.device | str | None = None) -> torch.Tensor:
    """(head_dim/2,) f32 inverse frequencies."""
    exp = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exp)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding on split halves (not interleaved pairs), in f32.
    x: (..., seq, heads, head_dim); positions: (..., seq)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)
    angles = positions[..., :, None].to(torch.float32) * freqs     # (..., seq, hd/2)
    angles = angles[..., None, :]                                  # (..., seq, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(length: int, dim: int,
                         device: torch.device | str | None = None) -> torch.Tensor:
    """Classic transformer sinusoidal table (whisper), (length, dim) f32:
    sin in the even columns, cos in the odd ones."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / dim))
    tab = torch.zeros((length, dim), dtype=torch.float32, device=device)
    tab[:, 0::2] = torch.sin(pos * div)
    tab[:, 1::2] = torch.cos(pos * div)
    return tab


def dense_init(generator: torch.Generator, shape: tuple[int, ...],
               dtype: torch.dtype = torch.bfloat16, scale: float | None = None) -> torch.Tensor:
    """N(0, 1) * scale in f32 (scale fan_in**-0.5 by default), then cast;
    drawn on the generator's device."""
    if scale is None:
        scale = shape[0] ** -0.5
    z = torch.randn(shape, generator=generator, dtype=torch.float32, device=generator.device)
    return (scale * z).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    # 1/sqrt(d) scale keeps tied-unembedding logits O(1) at init.
    return dense_init(generator, (vocab, dim), dtype, scale=dim ** -0.5)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor,
           act: Callable[[torch.Tensor], torch.Tensor] = F.silu) -> torch.Tensor:
    """Gated MLP: down( act(x @ gate) * (x @ up) )."""
    h = act(x @ w_gate) * (x @ w_up)
    h = shard_hint(h, ("batch",) + (None,) * (h.dim() - 2) + ("ff",))
    return shard_hint(h @ w_down, ("batch",) + (None,) * (x.dim() - 1))


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
             w_out: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
    """Whisper-style biased GELU MLP (the tanh GELU, as ``jax.nn.gelu``)."""
    return gelu(x @ w_in + b_in) @ w_out + b_out


def _chunk_loss(hc: torch.Tensor, unembed: torch.Tensor, tc: torch.Tensor, mc: torch.Tensor,
                softcap_value: float | None) -> torch.Tensor:
    logits = (hc @ unembed).to(torch.float32)
    if softcap_value is not None:
        logits = softcap(logits, softcap_value)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, tc[:, None].long())[:, 0]
    return torch.sum((logz - gold) * mc)


def chunked_cross_entropy(
    hidden: torch.Tensor,       # (tokens, d_model)
    unembed: torch.Tensor,      # (d_model, vocab)
    targets: torch.Tensor,      # (tokens,) int
    mask: torch.Tensor,         # (tokens,) f32
    n_chunks: int = 8,
    softcap_value: float | None = None,
) -> torch.Tensor:
    """Mean masked cross-entropy without the full (tokens, vocab) logits.

    Each token chunk's logits are made in f32 (soft-capped before the
    ``logsumexp``) under a non-reentrant ``torch.utils.checkpoint``, so
    only one chunk's logits exist at a time, in the forward and again in
    the backward pass: what keeps a 256,000-word vocabulary on one card.
    One chunk when ``n_chunks`` does not divide the tokens; the chunk sums
    add in order from zero and divide by ``max(sum(mask), 1)``, as the
    reference's scan does."""
    tokens = hidden.shape[0]
    if tokens % n_chunks != 0:
        n_chunks = 1
    chunk = tokens // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        rows = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpoint(_chunk_loss, hidden[rows], unembed, targets[rows], mask[rows],
                                   softcap_value, use_reentrant=False)
    return total / torch.clamp_min(torch.sum(mask), 1.0)


def tensor_from_array(a, device: torch.device | str) -> torch.Tensor:
    """A numpy array (e.g. a JAX array through ``np.asarray``) -> a tensor
    on ``device``, dtype kept.  bf16 (``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` rejects) is carried bit for bit through a
    ``uint16`` view."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.uint16), copy=True)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def array_from_tensor(t: torch.Tensor) -> np.ndarray:
    """A tensor -> a host numpy array; bf16 becomes float32 (exact), which
    ``jnp.asarray(a, jnp.bfloat16)`` takes back unchanged."""
    t = t.detach().cpu()
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()


def map_leaves(fn, tree):
    """``fn`` over the array leaves of a tree of NamedTuples, tuples and
    ``None``s, rebuilt with the same classes."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        items = [map_leaves(fn, x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return fn(tree)


def leaves(tree) -> list:
    """The tensor leaves of a tree of NamedTuples, tuples and ``None``s,
    in field order."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def stack_layers(make: Callable[[], object], n: int):
    """``n`` calls of ``make()``, one layer's tree each (NamedTuples with
    ``None`` leaves), as one tree whose leaves are stacked along a leading
    layer axis, as the reference's ``jax.vmap``-ed init gives them.  Each
    layer is copied into the stacked leaves as it is made, so no more
    than one layer's tree exists beside them."""
    first = make()
    out = map_leaves(lambda t: t.new_empty((n, *t.shape)), first)
    for i in range(n):
        for o, t in zip(leaves(out), leaves(first if i == 0 else make())):
            o[i].copy_(t)
    return out


def layer_slice(tree, i: int):
    """Layer ``i``'s slice (views) of a stacked tree."""
    return map_leaves(lambda t: t[i], tree)


def unstack_layers(tree, n: int) -> list:
    """The ``n`` per-layer slices of a stacked tree, each leaf ``unbind``
    once: its backward stacks the layers' gradients in one op, where an
    index per layer would add a zero-filled stacked gradient per layer."""
    if tree is None:
        return [None] * n
    if isinstance(tree, tuple):
        parts = [unstack_layers(x, n) for x in tree]
        return [type(tree)(*(part[i] for part in parts)) for i in range(n)]
    return list(torch.unbind(tree, 0))

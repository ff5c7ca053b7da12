"""Mixture-of-Experts decoder (qwen2-moe / grok-1); the full-sequence
(train, prefill) and decode paths of ``repro.models.moe``.

Routing is GShard/Switch-style capacity-based dispatch expressed as
einsums: tokens are processed in groups of at most ``MOE_GROUP``, each
group dispatches at most ``capacity`` tokens per expert, and the (group,
tokens, experts, capacity) one-hot tensors stay bounded because capacity
scales with the group size, not the global token count.  Expert FFN
weights are stacked (E, ...).  Shared experts (qwen2-moe: 4 always-on) are
a single fused swiglu of n_shared * moe_hidden width; grok-1 has none (its
``shared_*`` leaves are None).  The router aux (load-balance) loss follows
Switch: E * sum_e f_e * P_e.

Under a data mesh (``loss(..., data=)``, each rank a share of the batch)
the aux loss is the whole batch's: each layer's (E,) means f_e and P_e
are averaged over the ranks before their product (P_e's gradient stays
the rank's own, so the mean of the ranks' gradients is the whole
batch's).  The dispatch groups are the whole batch's too, as the
reference forms them over the global batch: the group size and capacity
come from the global token count, and rank r holds the global flat
positions [r t, (r + 1) t) of its t tokens.  Where that splits a group
(:class:`Split`), each layer all-gathers a small (group parts, k, E) table
of the ranks' selection counts, from which a rank takes its tokens' places
in each group's slot-major queue; no activation moves, and each rank runs
the expert FFN on its own tokens' slots.  A rank whose tokens are whole
groups runs today's step.

The dispatch is the reference's bookkeeping op for op, since who is
dropped at capacity depends on it: the top k come from a stable
descending sort (the lower expert id first among equal probabilities, as
``jax.lax.top_k``; ``torch.topk`` orders ties otherwise), and the position
one-hot is a comparison with ``arange(capacity)`` (``jax.nn.one_hot``
gives a zero row for a position at or past capacity, where
``F.one_hot`` raises).  The expert products are plain PyTorch, as the
reference's plain einsums are.

Per-layer parameters are stacked along a leading layer axis and the
layers run in a Python loop (``cfg.remat`` checkpoints each block).  The
decode's self-attention has no window and no soft-cap, so it takes the
"global" window (``transformer.GLOBAL_WINDOW``) and runs the
``swa_decode`` kernel on the card (``models/attention.decode_step``).
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
from repro_torch.models.transformer import GLOBAL_WINDOW

MOE_GROUP = 2048  # dispatch group size (tokens)


class MoEMLP(NamedTuple):
    w_router: torch.Tensor              # (d, E) f32
    w_gate: torch.Tensor                # (E, d, ff_e)
    w_up: torch.Tensor                  # (E, d, ff_e)
    w_down: torch.Tensor                # (E, ff_e, d)
    shared_gate: torch.Tensor | None    # (d, ff_s)
    shared_up: torch.Tensor | None
    shared_down: torch.Tensor | None


class BlockParams(NamedTuple):
    ln1: torch.Tensor
    attn: attn.AttnParams
    ln2: torch.Tensor
    mlp: MoEMLP


class Params(NamedTuple):
    embed: torch.Tensor
    blocks: BlockParams              # leaves stacked (n_layers, ...)
    final_norm: torch.Tensor
    unembed: torch.Tensor


def _init_mlp(g: torch.Generator, cfg: ModelConfig) -> MoEMLP:
    d, ffe, e = cfg.d_model, cfg.moe_hidden, cfg.n_experts
    shared = cfg.n_shared_experts > 0
    ffs = cfg.moe_hidden * cfg.n_shared_experts
    return MoEMLP(
        w_router=L.dense_init(g, (d, e), torch.float32),
        w_gate=L.dense_init(g, (e, d, ffe), cfg.dtype, scale=d ** -0.5),
        w_up=L.dense_init(g, (e, d, ffe), cfg.dtype, scale=d ** -0.5),
        w_down=L.dense_init(g, (e, ffe, d), cfg.dtype, scale=ffe ** -0.5),
        shared_gate=L.dense_init(g, (d, ffs), cfg.dtype) if shared else None,
        shared_up=L.dense_init(g, (d, ffs), cfg.dtype) if shared else None,
        shared_down=L.dense_init(g, (ffs, d), cfg.dtype) if shared else None,
    )


def _init_block(g: torch.Generator, cfg: ModelConfig) -> BlockParams:
    d = cfg.d_model
    return BlockParams(
        ln1=torch.zeros((d,), dtype=cfg.dtype, device=g.device),
        attn=attn.init(g, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.qk_norm, cfg.dtype),
        ln2=torch.zeros((d,), dtype=cfg.dtype, device=g.device),
        mlp=_init_mlp(g, cfg),
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
        unembed=L.dense_init(generator, (cfg.d_model, cfg.vocab_size), cfg.dtype),
    )


def axes(cfg: ModelConfig) -> Params:
    """Logical sharding axes, the structure of :class:`Params`."""
    shared = cfg.n_shared_experts > 0
    return Params(
        embed=("vocab", "embed"),
        blocks=BlockParams(
            ln1=("layers", "embed"),
            attn=attn.layer_axes(cfg.qk_norm),
            ln2=("layers", "embed"),
            mlp=MoEMLP(
                w_router=("layers", "embed", "experts"),
                w_gate=("layers", "experts", "embed", "ff"),
                w_up=("layers", "experts", "embed", "ff"),
                w_down=("layers", "experts", "ff", "embed"),
                shared_gate=("layers", "embed", "ff") if shared else None,
                shared_up=("layers", "embed", "ff") if shared else None,
                shared_down=("layers", "ff", "embed") if shared else None,
            ),
        ),
        final_norm=("embed",),
        unembed=("embed", "vocab"),
    )


def from_numpy(tree, device: torch.device | str | None = None) -> Params:
    """The reference's ``Params`` with numpy leaves (``jax.tree.map(
    np.asarray, params)``) -> the port's on ``device``, bit for bit."""
    dev = _device.resolve(device)

    def t(a):
        return None if a is None else L.tensor_from_array(a, dev)

    b = tree.blocks
    blocks = BlockParams(ln1=t(b.ln1), attn=attn.AttnParams(*(t(a) for a in b.attn)),
                         ln2=t(b.ln2), mlp=MoEMLP(*(t(a) for a in b.mlp)))
    return Params(embed=t(tree.embed), blocks=blocks, final_norm=t(tree.final_norm),
                  unembed=t(tree.unembed))


def to_numpy(params: Params) -> Params:
    """The inverse of :func:`from_numpy`: host numpy leaves (bf16 as f32)."""
    return L.map_leaves(L.array_from_tensor, params)


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values and their
    indices, the lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg: ModelConfig, g_size: int) -> int:
    """Tokens an expert takes per dispatch group, the reference's Python
    float arithmetic."""
    return max(1, int(cfg.capacity_factor * cfg.n_experts_per_tok * g_size / cfg.n_experts))


def route(mlp: MoEMLP, xg: torch.Tensor, cfg: ModelConfig):
    """The router of ``moe_apply`` over (g, t, d) groups: (dispatch (g, t,
    E, C) f32 0/1, combine (g, t, E, C) f32 gate weights, aux loss).
    Slot-major priority: every token's first choice is queued before any
    second choice."""
    dispatch, combine, me, fe = _route(mlp, xg, cfg)
    return dispatch, combine, aux_loss(me, fe, cfg)


def aux_loss(me: torch.Tensor, fe: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Switch's load-balance loss E * sum_e f_e P_e of the (..., E) means
    (summed over any leading axes)."""
    return cfg.n_experts * torch.sum(fe * me, dim=-1)


def _router(mlp: MoEMLP, xg: torch.Tensor, cfg: ModelConfig):
    """The router over (..., t, d) tokens: (gates (..., t, k) normalised,
    one-hot choices (..., t, k, E) f32, P_e (E,), f_e (E,))."""
    logits = torch.einsum("...td,de->...te", xg.to(torch.float32), mlp.w_router)
    probs = torch.softmax(logits, dim=-1)                  # (..., t, E)
    k, e = cfg.n_experts_per_tok, cfg.n_experts
    topv, topi = top_k(probs, k)                            # (..., t, k)
    topv = topv / torch.clamp_min(torch.sum(topv, dim=-1, keepdim=True), 1e-9)

    # Aux load-balance loss (Switch): E * sum_e f_e P_e.
    lead = tuple(range(probs.dim() - 1))
    me = torch.mean(probs, dim=lead)                        # (E,)
    onehot_top = F.one_hot(topi, e).to(torch.float32)       # (..., t, k, E)
    fe = torch.mean(torch.sum(onehot_top, dim=-2), dim=lead) / k
    return topv, onehot_top, me, fe


def _slot_one_hots(pos: torch.Tensor, sel: torch.Tensor, cap: int) -> torch.Tensor:
    """(..., C) one-hots of the queue positions ``pos`` of the selections
    ``sel`` (0/1) that fit under capacity ``cap``; zeros elsewhere."""
    keep = (pos < cap).to(torch.float32) * sel
    slots = torch.arange(cap, dtype=torch.float32, device=pos.device)
    return (pos[..., None] == slots).to(torch.float32) * keep[..., None]


def _route(mlp: MoEMLP, xg: torch.Tensor, cfg: ModelConfig):
    """:func:`route` with the aux loss's (E,) means instead of the loss:
    (dispatch, combine, P_e, f_e)."""
    n_groups, g_size, _ = xg.shape
    k, e = cfg.n_experts_per_tok, cfg.n_experts
    topv, onehot_top, me, fe = _router(mlp, xg, cfg)
    cap = capacity(cfg, g_size)
    sel = onehot_top.permute(0, 2, 1, 3)                    # (g, k, t, E)
    sel_flat = sel.reshape(n_groups, k * g_size, e)
    pos = torch.cumsum(sel_flat, dim=1) - sel_flat          # rank in queue
    disp = _slot_one_hots(pos, sel_flat, cap).reshape(n_groups, k, g_size, e, cap)

    gates = topv.permute(0, 2, 1)                           # (g, k, t)
    combine = torch.einsum("gktec,gkt->gtec", disp, gates)  # (g, t, E, C)
    dispatch = torch.sum(disp, dim=1)                       # (g, t, E, C)
    return dispatch, combine, me, fe


def moe_apply(mlp: MoEMLP, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Capacity-dispatch MoE over (..., d) tokens; returns (out, aux_loss).
    More than ``MOE_GROUP`` tokens must be a whole number of groups, as the
    reference's reshape requires."""
    out, me, fe = _moe_apply(mlp, x, cfg)
    return out, aux_loss(me, fe, cfg)


def _moe_apply(mlp: MoEMLP, x: torch.Tensor, cfg: ModelConfig):
    """:func:`moe_apply` with the aux loss's (E,) means: (out, P_e, f_e)."""
    orig_shape = x.shape
    d = orig_shape[-1]
    flat = x.reshape(-1, d)
    t = flat.shape[0]
    g_size = min(MOE_GROUP, t)
    if t % g_size:
        raise ValueError(f"{t} tokens are not a whole number of {g_size}-token MoE groups")
    xg = flat.reshape(t // g_size, g_size, d)
    dispatch, combine, me, fe = _route(mlp, xg, cfg)
    return _experts(mlp, dispatch, combine, xg).reshape(orig_shape), me, fe


def _experts(mlp: MoEMLP, dispatch: torch.Tensor, combine: torch.Tensor,
             xg: torch.Tensor) -> torch.Tensor:
    """The expert FFNs on (g, t, d) tokens dispatched into (g, t, E, C)
    slots, combined back with their gates, plus the shared expert: (g, t,
    d)."""
    expert_in = torch.einsum("gtec,gtd->gecd", dispatch.to(xg.dtype), xg)
    hg = F.silu(torch.einsum("gecd,edf->gecf", expert_in, mlp.w_gate))
    hu = torch.einsum("gecd,edf->gecf", expert_in, mlp.w_up)
    expert_out = torch.einsum("gecf,efd->gecd", hg * hu, mlp.w_down)
    out = torch.einsum("gtec,gecd->gtd", combine.to(xg.dtype), expert_out)
    if mlp.shared_gate is not None:
        out = out + L.swiglu(xg, mlp.shared_gate, mlp.shared_up, mlp.shared_down)
    return out


class Split(NamedTuple):
    """A data rank's ``tokens`` as parts of the global dispatch groups of
    ``g_size`` (module doc): rank r of ``mesh`` holds the global flat
    positions [r tokens, (r + 1) tokens)."""
    mesh: object              # launch/sharding.ClientMesh of the data ranks
    g_size: int
    tokens: int

    def span(self, rank: int) -> tuple[int, int]:
        """(first global group, groups touched) of ``rank``'s tokens."""
        start = rank * self.tokens
        first = start // self.g_size
        return first, (start + self.tokens - 1) // self.g_size - first + 1

    def parts(self) -> list[tuple[int, int]]:
        """This rank's (start, stop) local token ranges, one a group."""
        start = self.mesh.rank * self.tokens
        first, n = self.span(self.mesh.rank)
        cuts = [start] + [(first + p) * self.g_size for p in range(1, n)] + [start + self.tokens]
        return [(a - start, b - start) for a, b in zip(cuts, cuts[1:])]


def data_split(tokens: int, data) -> Split | None:
    """The :class:`Split` of a data rank's ``tokens`` over ``data``, or None
    when there is no mesh of more than one rank or each rank's tokens are
    whole groups (then every rank forms its own groups, as today).  A
    global token count past ``MOE_GROUP`` that is not a whole number of
    groups raises, as the reference's reshape of the global batch does."""
    if data is None or data.size == 1:
        return None
    total = tokens * data.size
    g_size = min(MOE_GROUP, total)
    if total % g_size:
        raise ValueError(f"{total} tokens over {data.size} data ranks are not a whole number "
                         f"of {g_size}-token MoE groups")
    return None if tokens % g_size == 0 else Split(data, g_size, tokens)


def _split_bases(split: Split, counts: torch.Tensor) -> torch.Tensor:
    """Each of this rank's group parts' (k, E) queue offsets: the group's
    selections at the earlier slots, from every rank, plus those at the
    same slot from the ranks before this one.  ``counts`` is every rank's
    (parts, k, E) table, (W, P, k, E), P the most parts a rank holds."""
    w, n_max = counts.shape[:2]
    first, n = split.span(split.mesh.rank)
    spans = [split.span(r) for r in range(w)]
    # in_group[p, r, q]: rank r's part q is this rank's part p's group.
    in_group = torch.tensor([[[q < m and f + q == first + p for q in range(n_max)]
                              for f, m in spans] for p in range(n)], dtype=torch.float32)
    before = in_group * (torch.arange(w) < split.mesh.rank).to(torch.float32)[None, :, None]
    c = counts.to(torch.float32)
    total = torch.einsum("prq,rqke->pke", in_group.to(c.device), c)
    earlier = torch.einsum("prq,rqke->pke", before.to(c.device), c)
    return torch.cumsum(total, dim=1) - total + earlier


def _split_moe_apply(mlp: MoEMLP, x: torch.Tensor, cfg: ModelConfig, split: Split):
    """:func:`_moe_apply` on a data rank's tokens whose groups span ranks:
    the reference's dispatch of the global groups, restricted to this
    rank's tokens.  One collective (an all-gather of the (parts, k, E)
    selection counts); under ``cfg.remat`` the checkpointed block runs it
    again in its recompute, which is sound: every rank recomputes the same
    layers in the same order, and the counts are integers, with no
    gradient.  Each group part runs all E x C expert slots, so a group
    spread over W ranks pays W times its expert FFN."""
    orig_shape = x.shape
    d = orig_shape[-1]
    flat = x.reshape(-1, d)
    k, e = cfg.n_experts_per_tok, cfg.n_experts
    cap = capacity(cfg, split.g_size)
    topv, onehot_top, me, fe = _router(mlp, flat, cfg)      # (t, k), (t, k, E)
    sel = onehot_top.permute(1, 0, 2)                       # (k, t, E)
    parts = split.parts()
    n_max = max(split.span(r)[1] for r in range(split.mesh.size))
    local = torch.zeros((n_max, k, e), dtype=torch.int32, device=x.device)
    for p, (a, b) in enumerate(parts):
        local[p] = torch.sum(sel[:, a:b], dim=1).to(torch.int32)
    counts = split.mesh.gather_rows(local[None], split.mesh.size, dim=0)   # (W, P, k, E)
    bases = _split_bases(split, counts)                     # (parts, k, E)
    outs = []
    for p, (a, b) in enumerate(parts):
        s_p = sel[:, a:b]                                   # (k, t_p, E)
        pos = torch.cumsum(s_p, dim=1) - s_p + bases[p][:, None, :]   # rank in the group's queue
        disp = _slot_one_hots(pos, s_p, cap)                # (k, t_p, E, C)
        combine = torch.einsum("ktec,tk->tec", disp, topv[a:b])
        dispatch = torch.sum(disp, dim=0)                   # (t_p, E, C)
        outs.append(_experts(mlp, dispatch[None], combine[None], flat[None, a:b])[0])
    return torch.cat(outs, dim=0).reshape(orig_shape), me, fe


def _block_apply(cfg: ModelConfig, bp: BlockParams, x: torch.Tensor, positions: torch.Tensor,
                 split: Split | None = None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    h = attn.full_attention(bp.attn, L.rms_norm(x, bp.ln1), positions,
                            rope_theta=cfg.rope_theta)
    x = x + h
    if split is None:
        h, me, fe = _moe_apply(bp.mlp, L.rms_norm(x, bp.ln2), cfg)
    else:
        h, me, fe = _split_moe_apply(bp.mlp, L.rms_norm(x, bp.ln2), cfg, split)
    return x + h, me, fe


def forward(params: Params, batch: dict, cfg: ModelConfig,
            data=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(hidden states after the final norm (b, s, d), the router aux loss
    summed over the layers, f32).  With ``data`` (a
    ``launch/sharding.ClientMesh`` over which the batch is split) the
    dispatch groups and the aux loss are the whole batch's (module doc),
    the aux means reduced in one ``all_reduce`` outside the checkpointed
    blocks."""
    x = params.embed[batch["tokens"]]
    b, s = batch["tokens"].shape
    split = data_split(b * s, data)
    positions = torch.arange(s, device=x.device).expand(b, s)
    mes, fes = [], []
    for bp in L.unstack_layers(params.blocks, cfg.n_layers):
        if cfg.remat:
            x, me, fe = checkpoint(_block_apply, cfg, bp, x, positions, split,
                                   use_reentrant=False)
        else:
            x, me, fe = _block_apply(cfg, bp, x, positions, split)
        mes.append(me)
        fes.append(fe)
    h = L.rms_norm(x, params.final_norm)
    if data is None or data.size == 1:
        return h, torch.sum(torch.stack([aux_loss(me, fe, cfg) for me, fe in zip(mes, fes)]))
    me, fe = torch.stack(mes), torch.stack(fes)                  # (layers, E)
    both = data.mean_(torch.stack([me.detach(), fe]))
    me = me + (both[0] - me.detach())      # the batch's P_e, the rank's own gradient
    return h, torch.sum(aux_loss(me, both[1], cfg))


def loss(params: Params, batch: dict, cfg: ModelConfig, data=None) -> torch.Tensor:
    """Next-token cross-entropy plus ``router_aux_coef`` x the aux loss;
    with ``data`` the aux loss is the whole batch's (:func:`forward`), so
    the mean of the ranks' losses is the one-process loss."""
    h, aux = forward(params, batch, cfg, data)
    b, s, d = h.shape
    ce = L.chunked_cross_entropy(
        h[:, :-1].reshape(-1, d), params.unembed, batch["tokens"][:, 1:].reshape(-1),
        torch.ones((b * (s - 1),), dtype=torch.float32, device=h.device),
        n_chunks=cfg.loss_chunks,
    )
    return ce + cfg.router_aux_coef * aux


class DecodeCache(NamedTuple):
    kv: attn.KVCache        # leaves stacked (n_layers, ...)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, long_context: bool = False,
               device: torch.device | str | None = None) -> DecodeCache:
    """Zero caches, one per layer, stacked (``long_context`` changes
    nothing, as in the reference)."""
    return DecodeCache(kv=attn.init_layer_caches(cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
                                                 cfg.head_dim, cfg.dtype, device))


def decode_step(params: Params, cache: DecodeCache, tokens: torch.Tensor, cfg: ModelConfig,
                long_context: bool = False) -> tuple[DecodeCache, torch.Tensor]:
    """Serve one token for the whole batch; returns (cache, logits (b, 1,
    vocab) f32).  The batch is one dispatch group, so capacity is often 1
    and tokens that pick the same expert are dropped, as in the
    reference."""
    x = params.embed[tokens]
    lengths = []
    for i in range(cfg.n_layers):
        bp = L.layer_slice(params.blocks, i)
        kv = attn.KVCache(cache.kv.k[i], cache.kv.v[i], cache.kv.length[i])
        kv, h = attn.decode_step(bp.attn, kv, L.rms_norm(x, bp.ln1), window=GLOBAL_WINDOW,
                                 rope_theta=cfg.rope_theta)
        lengths.append(kv.length)
        x = x + h
        h, _ = moe_apply(bp.mlp, L.rms_norm(x, bp.ln2), cfg)
        x = x + h
    h = L.rms_norm(x, params.final_norm)
    logits = (h @ params.unembed).to(torch.float32)
    return DecodeCache(kv=attn.KVCache(cache.kv.k, cache.kv.v, torch.stack(lengths))), logits

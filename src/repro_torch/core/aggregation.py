"""Aggregation operators for hierarchical FL (paper Eqs. 13, 15, 16).

Per-client updates are flat (N, d) tensors (the ravel order of
``models/autoencoder``); fog aggregation sums them by cluster id,
cooperative mixing is a gather plus a convex combination, and global
aggregation a weighted sum.  The client axis can be walked in chunks
(``chunk=``: compression transients scale with the chunk, not the
fleet), and the fog reduce can be Byzantine-robust
(:func:`robust_compress_and_aggregate`).  A batch of B trials folds into
the client and fog axes of these operators: trial b's clients carry fog
ids offset by b * M into B * M fogs, so a fog's members are all of one
trial and its sum is that trial's own.  Mixing and the gateway step take
(B, M, d).  Over a client mesh (``launch/sharding.ClientMesh``, a
``torch.distributed`` process group) :func:`compress_and_aggregate` sums
each rank's partial fog sums before dividing; :func:`hierarchical_mean`
and :func:`ring_mix` are the reference's mesh-parallel mean and gossip.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core import compression as comp
from repro_torch.core.cooperation import CoopDecision
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import segment_sum as _segment_sum


def fog_aggregate(
    updates: torch.Tensor,    # (N, ...) per-client updates
    fog_id: torch.Tensor,     # (N,) int
    weights: torch.Tensor,    # (N,) f32 — n_i, zeroed for non-participants
    n_fog: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Intra-cluster weighted aggregation (Eq. 13): (fog_updates (M, ...),
    fog_weight (M,)), fog_updates[m] = sum_{i in C_m} n_i / sum_C n * u_i."""
    fog_weight = _segment_sum(weights, fog_id, n_fog)
    denom = torch.clamp_min(fog_weight, 1e-12)
    w = weights.reshape((-1,) + (1,) * (updates.dim() - 1))
    summed = _segment_sum(updates * w, fog_id, n_fog)
    return summed / denom.reshape((-1,) + (1,) * (updates.dim() - 1)), fog_weight


def _wire_k_frac(d: int, cfg: comp.CompressorConfig) -> float | None:
    """Per-block keep fraction if the sparse wire applies (compression
    on, sparse, fused, blockwise), else None."""
    if not (cfg.enabled and cfg.is_sparse and cfg.fused and cfg.mode == "blockwise"):
        return None
    comp.validate_blockwise_bits(cfg.quant_bits)
    return comp.blockwise_k_frac(d, cfg.rho_s)


def _finite_rows(deltas: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    return torch.all(torch.isfinite(deltas), dim=-1) & torch.all(torch.isfinite(err), dim=-1)


def _chunked_compress_and_accumulate(
    deltas, err, fog_id, weights, n_fog: int, cfg: comp.CompressorConfig, chunk: int,
):
    """Compress and accumulate ``chunk`` clients at a time, so compression
    transients are O(chunk * d), not O(N * d).

    A fused blockwise config takes the sparse wire: per chunk, the
    isfinite guard, ``wire_emit`` into one chunk-sized wire buffer (reused
    by every chunk) and the chunk's rows of the round's error-feedback
    buffer, then ``wire_agg`` adding the chunk into the (n_fog, d) fog
    sums in place.  Anything else takes the dense per-chunk path.  The
    last chunk holds the remaining rows (the reference re-reads overlap
    rows at zero weight instead, which adds exactly 0).  Sums are
    re-associated against the one-shot path, so they agree to float
    tolerance, not bitwise.
    """
    n, d = deltas.shape
    dev = deltas.device
    fog_sum = torch.zeros((n_fog, d), dtype=torch.float32, device=dev)
    fog_weight = torch.zeros((n_fog,), dtype=torch.float32, device=dev)
    new_err = torch.empty((n, d), dtype=deltas.dtype, device=dev)
    k_frac = _wire_k_frac(d, cfg)
    if k_frac is not None:
        quantize = cfg.quant_bits < 32
        k, nb = kops.wire_k(k_frac), -(-d // kops.BLOCK_ELEMS)
        wire = (torch.empty((chunk, nb, k), dtype=torch.int32, device=dev),
                torch.empty((chunk, nb, k), dtype=torch.int8 if quantize else torch.float32,
                            device=dev),
                torch.empty((chunk, nb), dtype=torch.float32, device=dev))
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        dc, ec, fc, wc = deltas[s:e], err[s:e], fog_id[s:e], weights[s:e]
        if k_frac is None:
            part, part_w, new_err[s:e] = compress_and_accumulate(
                dc, ec, fc, wc, n_fog, comp.for_rows(cfg, s, e))
            fog_sum += part
            fog_weight += part_w
            continue
        finite = _finite_rows(dc, ec)
        dc = torch.where(finite[:, None], dc, 0.0)
        ec = torch.where(finite[:, None], ec, 0.0)
        wc = wc * finite.to(wc.dtype)
        fog_weight += _segment_sum(wc, fc, n_fog)
        idx, q, scale = (t[:e - s] for t in wire)
        kops.compress_wire(dc, ec, k_frac, quantize, out=(idx, q, scale, new_err[s:e]))
        kops.wire_aggregate(idx, q, scale, fc, wc, n_fog, d, out=fog_sum)
    return fog_sum, fog_weight, new_err


def compress_and_accumulate(
    deltas: torch.Tensor,     # (N, d) raw flat client updates
    err: torch.Tensor,        # (N, d) error-feedback buffers
    fog_id: torch.Tensor,     # (N,) int32 cluster assignment
    weights: torch.Tensor,    # (N,) f32, zeroed for non-participants
    n_fog: int,
    cfg: comp.CompressorConfig,
    chunk: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-client compression + UNNORMALISED weighted fog sums (one pass).

    Returns (fog_sum (n_fog, d) = sum_{i in C_m} w_i recon_i,
    fog_weight (n_fog,) = sum_{i in C_m} w_i, new_err (N, d)).

    Rows carrying any NaN/Inf (a diverging client) are zeroed — delta, EF
    buffer and weight — before they touch the fog sums; a no-op for
    finite inputs.  ``chunk`` (``HFLConfig.client_chunk``): None or
    ``chunk >= N`` is the one-shot path below, a smaller chunk walks the
    clients in chunks (:func:`_chunked_compress_and_accumulate`).
    """
    if chunk is not None and 0 < chunk < deltas.shape[0]:
        return _chunked_compress_and_accumulate(deltas, err, fog_id, weights, n_fog, cfg, chunk)
    finite = _finite_rows(deltas, err)
    deltas = torch.where(finite[:, None], deltas, 0.0)
    err = torch.where(finite[:, None], err, 0.0)
    weights = weights * finite.to(weights.dtype)
    fog_weight = _segment_sum(weights, fog_id, n_fog)

    if cfg.enabled and cfg.is_sparse and cfg.fused and cfg.mode == "blockwise":
        # The fused path: EF Top-K + int8 + weighted accumulation straight
        # into the (n_fog, d) buffers; the dense per-client reconstruction
        # never exists.
        comp.validate_blockwise_bits(cfg.quant_bits)
        fog_sum, new_err = kops.compress_aggregate(
            deltas, err, fog_id, weights, n_fog,
            comp.blockwise_k_frac(deltas.shape[1], cfg.rho_s),
            quantize=cfg.quant_bits < 32,
        )
        return fog_sum, fog_weight, new_err

    # Compression off, quantise-only rho_s == 1, mode="global" or
    # fused=False: per-client reconstruction (the compress_q8 / topk_ef
    # kernels for blockwise), then a dense segment sum (index_add_: on the
    # card its atomics add in no fixed order, so these sums agree with
    # other paths to float tolerance, not bitwise).
    recon, new_err = comp.compress_update(deltas, err, cfg)
    fog_sum = _segment_sum(recon * weights[:, None], fog_id, n_fog)
    return fog_sum, fog_weight, new_err


def compress_and_aggregate(
    deltas: torch.Tensor,
    err: torch.Tensor,
    fog_id: torch.Tensor,
    weights: torch.Tensor,
    n_fog: int,
    cfg: comp.CompressorConfig,
    axis: Any = None,
    chunk: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eq. 30 (EF compression) and Eq. 13 (weighted fog aggregation) as
    one operator: (fog_update (n_fog, d) — the cluster means, zero for
    empty clusters — fog_weight (n_fog,), new_err (N, d)).  ``chunk`` as
    in :func:`compress_and_accumulate`, within this rank's clients.

    With ``axis`` a ``launch/sharding.ClientMesh`` the inputs are this
    rank's slice of the clients, and the partial fog sums and weights are
    summed over the mesh before dividing (the sensor->fog hop);
    ``new_err`` stays this rank's slice."""
    fog_sum, fog_weight, new_err = compress_and_accumulate(
        deltas, err, fog_id, weights, n_fog, cfg, chunk=chunk
    )
    if axis is not None:
        axis.sum_(fog_sum)
        axis.sum_(fog_weight)
    return fog_sum / torch.clamp_min(fog_weight, 1e-12)[:, None], fog_weight, new_err


def client_compress(
    deltas: torch.Tensor,     # (N, d) raw flat client updates
    err: torch.Tensor,        # (N, d) error-feedback buffers
    cfg: comp.CompressorConfig,
    chunk: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-client compression with identity segments (fog i = client i,
    unit weights), so each client's dequantised reconstruction stays
    addressable: (recon (N, d), new_err (N, d)).  With ``chunk < N`` the
    clients go ``chunk`` at a time into the (N, d) outputs; every row is a
    function of that row alone, so the result is bitwise the unchunked
    one at every chunk."""
    n, d = deltas.shape
    if chunk is None or chunk <= 0 or chunk >= n:
        ids = torch.arange(n, dtype=torch.int32, device=deltas.device)
        ones = torch.ones((n,), dtype=torch.float32, device=deltas.device)
        recon, _, new_err = compress_and_accumulate(deltas, err, ids, ones, n, cfg)
        return recon, new_err
    recon = torch.empty((n, d), dtype=torch.float32, device=deltas.device)
    new_err = torch.empty((n, d), dtype=deltas.dtype, device=deltas.device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        ids = torch.arange(e - s, dtype=torch.int32, device=deltas.device)
        ones = torch.ones((e - s,), dtype=torch.float32, device=deltas.device)
        recon[s:e], _, new_err[s:e] = compress_and_accumulate(
            deltas[s:e], err[s:e], ids, ones, e - s, comp.for_rows(cfg, s, e))
    return recon, new_err


def robust_compress_and_aggregate(
    deltas: torch.Tensor,     # (N, d) raw flat client updates
    err: torch.Tensor,        # (N, d) error-feedback buffers
    fog_id: torch.Tensor,     # (N,) int32 cluster assignment
    weights: torch.Tensor,    # (N,) f32, zeroed for non-participants
    n_fog: int,
    cfg: comp.CompressorConfig,
    trim_frac: float,
    mode: str,                # "trimmed" | "median"
    chunk: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Byzantine-robust variant of :func:`compress_and_aggregate`: the
    same compression through per-client segments (:func:`client_compress`,
    so the EF math equals the mean path's), then the coordinate-wise
    trimmed mean / median per fog (``kernels/ops.robust_aggregate``).
    Rows the isfinite guard zeroed lose their weight too, or a zeroed row
    would pull the order statistic toward 0.

    Returns (fog_update (n_fog, d) — NORMALISED robust aggregates —
    fog_weight (n_fog,), new_err (N, d)).
    """
    recon, new_err = client_compress(deltas, err, cfg, chunk=chunk)
    finite = _finite_rows(deltas, err)
    fog_out, fog_weight = kops.robust_aggregate(
        recon, fog_id, weights * finite.to(weights.dtype), n_fog, trim_frac, mode,
    )
    return fog_out, fog_weight, new_err


def cooperative_mix(fog_models: torch.Tensor, decision: CoopDecision) -> torch.Tensor:
    """Cooperative fog mixing (Eq. 15, K = 1): theta~_m = alpha_mm theta_m
    + alpha_mj theta_j; non-cooperating fogs have partner m and weights
    (1, 0), the identity.  ``fog_models`` (..., M, d) and the decision's
    (..., M) leaves may carry leading trial axes.

    The sum is one fused multiply-add, fma(alpha_mm, theta_m, alpha_mj
    theta_j): the partner product is rounded first, then the own product
    is added to it in one rounding, the contraction the reference's jitted
    round makes.  Rounding both products before the sum leaves an ulp
    where the reference leaves none, which FedAdam's first steps turn into
    an O(``server_lr``) move."""
    peer = torch.take_along_dim(fog_models, decision.partner[..., None], dim=-2)
    return torch.addcmul(decision.partner_weight[..., None] * peer,
                         decision.self_weight[..., None], fog_models)


def global_aggregate(
    fog_models: torch.Tensor,            # (..., M, d)
    fog_weight: torch.Tensor,            # (..., M) — sum of n_i over the cluster
    prev: torch.Tensor | None = None,    # (..., d) carry-through for a dead round
) -> torch.Tensor:
    """Surface-gateway aggregation (Eq. 16): data-weighted fog average.
    With ``prev``, a round with no weight at all returns ``prev`` instead
    of collapsing the model to zeros."""
    return weighted_mean(fog_models, fog_weight, prev)


def weighted_mean(
    updates: torch.Tensor, weights: torch.Tensor, prev: torch.Tensor | None = None,
) -> torch.Tensor:
    """Weighted average over the rows of ``updates`` (..., R, d) by
    ``weights`` (..., R) (FedAvg, Eq. 11), per trial of the leading axes;
    the same zero-total-weight rule as :func:`global_aggregate`.

    On the card each trial of the leading axes is its own (1, R) x (R, d)
    product: cuBLAS picks a batched product's reduction order by the batch
    count, so a trial's mean would move with the trials folded beside it
    (an ``Engine.sweep`` cell would part from its own ``Engine.run``).  On
    the CPU the batched product is each trial's own already, and its fma
    order is the reference's."""
    total = torch.sum(weights, dim=-1)
    w = weights / torch.clamp_min(total, 1e-12)[..., None]
    if updates.is_cuda and updates.dim() > 2:
        rows_w = w.reshape(-1, 1, w.shape[-1])
        rows_u = updates.reshape(-1, *updates.shape[-2:])
        out = torch.cat([torch.matmul(a, b) for a, b in zip(rows_w, rows_u)])
        out = out.reshape(updates.shape[:-2] + updates.shape[-1:])
    else:
        out = torch.matmul(w.unsqueeze(-2), updates).squeeze(-2)
    if prev is None:
        return out
    return torch.where((total > 0.0)[..., None], out, prev)


# ---------------------------------------------------------------------------
# Mesh-parallel hierarchical aggregation over process groups.
# ---------------------------------------------------------------------------

def tree_map(fn, tree: Any) -> Any:
    """``fn`` on every tensor of a tensor, or of lists, tuples and dicts
    of them (a params pytree)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def hierarchical_mean(
    update: Any,
    weight: torch.Tensor,
    *,
    intra_axis: Any,
    inter_axis: Any = None,
) -> Any:
    """Two-level weighted mean of every rank's ``update`` (a tensor or a
    params pytree) by its ``weight`` (a scalar tensor): within
    ``intra_axis`` (a ``ClientMesh``: the cheap hop, fog aggregation),
    then across ``inter_axis`` (the expensive hop, fog->gateway), each
    weighted by the summed weight below it.  ``inter_axis=None`` is flat
    FedAvg over ``intra_axis``.  At size 1 both hops are the identity
    (up to ``w * x / w``)."""
    wsum_local = intra_axis.sum_(weight.clone())

    def intra(leaf):
        return intra_axis.sum_(leaf * weight) / torch.clamp_min(wsum_local, 1e-12)

    fog_model = tree_map(intra, update)
    if inter_axis is None:
        return fog_model
    wsum_global = inter_axis.sum_(wsum_local.clone())

    def inter(leaf):
        return inter_axis.sum_(leaf * wsum_local) / torch.clamp_min(wsum_global, 1e-12)

    return tree_map(inter, fog_model)


def ring_mix(update: Any, mix_weight: float, axis: Any) -> Any:
    """Gossip with the ring neighbour over ``axis`` (a ``ClientMesh``),
    the mesh analogue of fog-to-fog cooperation: rank r mixes in rank
    r - 1's leaf, ``(1 - w) x_r + w x_{r-1}``.  At size 1 the neighbour
    is the rank itself, with no communication."""
    n = axis.size
    if n > 1:   # the ring neighbours' ranks in the default group
        nxt, prv = ((axis.rank + 1) % n, (axis.rank - 1) % n) if axis.group is None else (
            dist.get_global_rank(axis.group, (axis.rank + 1) % n),
            dist.get_global_rank(axis.group, (axis.rank - 1) % n))

    def peer_of(leaf):
        if n == 1:
            return leaf
        peer = torch.empty_like(leaf)
        ops = [dist.P2POp(dist.isend, leaf.contiguous(), nxt, axis.group),
               dist.P2POp(dist.irecv, peer, prv, axis.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return peer

    return tree_map(lambda leaf: (1.0 - mix_weight) * leaf + mix_weight * peer_of(leaf), update)

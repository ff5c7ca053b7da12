"""Aggregation operators for hierarchical FL (paper Eqs. 13, 15, 16).

Per-client updates are flat (N, d) tensors (the ravel order of
``models/autoencoder``); fog aggregation sums them by cluster id,
cooperative mixing is a gather plus a convex combination, and global
aggregation a weighted sum.  The one-shot round path of the reference;
its client-chunked, robust and mesh-parallel paths are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core import compression as comp
from repro_torch.core.cooperation import CoopDecision
from repro_torch.kernels import ops as kops


def _segment_sum(x: torch.Tensor, fog_id: torch.Tensor, n_fog: int) -> torch.Tensor:
    out = torch.zeros((n_fog,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, fog_id.long(), x)


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


def compress_and_accumulate(
    deltas: torch.Tensor,     # (N, d) raw flat client updates
    err: torch.Tensor,        # (N, d) error-feedback buffers
    fog_id: torch.Tensor,     # (N,) int32 cluster assignment
    weights: torch.Tensor,    # (N,) f32, zeroed for non-participants
    n_fog: int,
    cfg: comp.CompressorConfig,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-client compression + UNNORMALISED weighted fog sums (one pass).

    Returns (fog_sum (n_fog, d) = sum_{i in C_m} w_i recon_i,
    fog_weight (n_fog,) = sum_{i in C_m} w_i, new_err (N, d)).

    Rows carrying any NaN/Inf (a diverging client) are zeroed — delta, EF
    buffer and weight — before they touch the fog sums; a no-op for
    finite inputs.
    """
    finite = torch.all(torch.isfinite(deltas), dim=-1) & torch.all(torch.isfinite(err), dim=-1)
    deltas = torch.where(finite[:, None], deltas, 0.0)
    err = torch.where(finite[:, None], err, 0.0)
    weights = weights * finite.to(weights.dtype)
    fog_weight = _segment_sum(weights, fog_id, n_fog)

    if cfg.enabled and cfg.is_sparse and cfg.mode == "blockwise":
        if not cfg.fused:
            raise NotImplementedError(comp.UNPORTED_BLOCKWISE)
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

    # Compression off, dense rho_s == 1, or mode="global": per-client
    # reconstruction, then a dense segment sum.
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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eq. 30 (EF compression) and Eq. 13 (weighted fog aggregation) as
    one operator: (fog_update (n_fog, d) — the cluster means, zero for
    empty clusters — fog_weight (n_fog,), new_err (N, d))."""
    fog_sum, fog_weight, new_err = compress_and_accumulate(
        deltas, err, fog_id, weights, n_fog, cfg
    )
    return fog_sum / torch.clamp_min(fog_weight, 1e-12)[:, None], fog_weight, new_err


def cooperative_mix(fog_models: torch.Tensor, decision: CoopDecision) -> torch.Tensor:
    """Cooperative fog mixing (Eq. 15, K = 1): theta~_m = alpha_mm theta_m
    + alpha_mj theta_j; non-cooperating fogs have partner m and weights
    (1, 0), the identity."""
    peer = fog_models[decision.partner]
    return decision.self_weight[:, None] * fog_models + decision.partner_weight[:, None] * peer


def global_aggregate(
    fog_models: torch.Tensor,            # (M, d)
    fog_weight: torch.Tensor,            # (M,) — sum of n_i over the cluster
    prev: torch.Tensor | None = None,    # (d,) carry-through for a dead round
) -> torch.Tensor:
    """Surface-gateway aggregation (Eq. 16): data-weighted fog average.
    With ``prev``, a round with no weight at all returns ``prev`` instead
    of collapsing the model to zeros."""
    return weighted_mean(fog_models, fog_weight, prev)


def weighted_mean(
    updates: torch.Tensor, weights: torch.Tensor, prev: torch.Tensor | None = None,
) -> torch.Tensor:
    """Weighted average over the leading axis (FedAvg, Eq. 11); the same
    zero-total-weight rule as :func:`global_aggregate`."""
    total = torch.sum(weights)
    w = weights / torch.clamp_min(total, 1e-12)
    out = torch.tensordot(w, updates, dims=([0], [0]))
    if prev is None:
        return out
    return torch.where(total > 0.0, out, prev)

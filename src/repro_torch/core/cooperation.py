"""Fog-level cooperation rules (paper Sec. IV-E / V-B, Eqs. 14, 28-29).

All three rules return a :class:`CoopDecision` with, per fog node m:

  - ``partner``: the single neighbour j it mixes with (K=1 in the paper's
    rule family), or ``m`` itself when it does not cooperate;
  - ``self_weight`` / ``partner_weight``: the mixing coefficients
    (alpha_mm, alpha_mj), rows of a (sub-)stochastic mixing matrix (Eq. 14);
  - ``cooperates``: boolean mask (drives the fog-to-fog energy term, Eq. 18).
"""
from __future__ import annotations

import enum
from typing import NamedTuple

import torch

from repro_torch.core import channel as ch


class CoopRule(enum.Enum):
    NOCOOP = "nocoop"
    NEAREST = "nearest"
    SELECTIVE = "selective"


class CoopDecision(NamedTuple):
    partner: torch.Tensor         # (M,) int64
    self_weight: torch.Tensor     # (M,) f32
    partner_weight: torch.Tensor  # (M,) f32
    cooperates: torch.Tensor      # (M,) bool
    dist_m: torch.Tensor          # (M,) distance to partner (0 when not cooperating)


# Paper's fixed mixing weights.
NEAREST_WEIGHTS = (0.7, 0.3)     # HFL-Nearest (Sec. V-B)
SELECTIVE_WEIGHTS = (0.8, 0.2)   # HFL-Selective (Eq. 29)

F32 = torch.float32


def _fog_distance_matrix(fog_pos: torch.Tensor) -> torch.Tensor:
    d = ch.pairwise_distances(fog_pos, fog_pos)
    return d + torch.diag(torch.full((fog_pos.shape[0],), torch.inf, device=d.device))


def _decision(coop, partner, dist, weights) -> CoopDecision:
    idx = torch.arange(coop.shape[0], device=coop.device)
    w_self, w_peer = weights
    return CoopDecision(
        partner=torch.where(coop, partner, idx),
        self_weight=torch.where(coop, w_self, 1.0).to(F32),
        partner_weight=torch.where(coop, w_peer, 0.0).to(F32),
        cooperates=coop,
        dist_m=torch.where(coop, dist, 0.0),
    )


def no_cooperation(fog_pos: torch.Tensor) -> CoopDecision:
    """HFL-NoCoop: N_m = empty set for every fog."""
    m = fog_pos.shape[0]
    dev = fog_pos.device
    return CoopDecision(
        partner=torch.arange(m, device=dev),
        self_weight=torch.ones((m,), dtype=F32, device=dev),
        partner_weight=torch.zeros((m,), dtype=F32, device=dev),
        cooperates=torch.zeros((m,), dtype=torch.bool, device=dev),
        dist_m=torch.zeros((m,), dtype=F32, device=dev),
    )


def nearest_cooperation(
    fog_pos: torch.Tensor, cluster_size: torch.Tensor, cparams: ch.ChannelParams,
) -> CoopDecision:
    """HFL-Nearest: always-on cooperation with the nearest feasible fog
    that serves a nonempty cluster (and only for nonempty fogs), so that
    mixing, energy and latency masks agree."""
    d = _fog_distance_matrix(fog_pos)
    nonempty = cluster_size > 0
    feas = ch.feasible(d, cparams) & nonempty[None, :]
    partner = torch.argmin(torch.where(feas, d, torch.inf), dim=-1)
    has_any = torch.any(feas, dim=-1) & nonempty
    pdist = torch.gather(d, 1, partner[:, None])[:, 0]
    return _decision(has_any, partner, pdist, NEAREST_WEIGHTS)


def selective_cooperation(
    fog_pos: torch.Tensor,
    cluster_size: torch.Tensor,
    cparams: ch.ChannelParams,
    eligibility_factor: float = 0.75,
) -> CoopDecision:
    """HFL-Selective (paper Eqs. 28-29).

    A fog m cooperates iff its cluster is small, c_m <= max(2, f * mean
    nonempty c) (28), and a feasible neighbour with a strictly larger
    (hence nonempty) cluster lies closer than the first quartile of the
    feasible fog-fog distances; it then mixes 0.8/0.2 with the nearest
    such neighbour (29).  With no feasible pair at all the quartile is
    taken over zeros, and no fog cooperates.
    """
    d = _fog_distance_matrix(fog_pos)
    feas = ch.feasible(d, cparams)
    c = cluster_size.to(F32)
    nonempty = c > 0
    ne = nonempty.to(F32)
    mean_c = torch.sum(c * ne) / torch.clamp_min(torch.sum(ne), 1.0)
    eligible = c <= torch.clamp_min(eligibility_factor * mean_c, 2.0)        # (28)
    any_feasible = torch.any(feas)
    feas_d = torch.where(feas, d, torch.nan)
    q1 = torch.nanquantile(torch.where(any_feasible, feas_d, 0.0).reshape(-1), 0.25)
    larger = (c[None, :] > c[:, None]) & nonempty[None, :]
    candidate = feas & larger & (d < q1)
    partner = torch.argmin(torch.where(candidate, d, torch.inf), dim=-1)
    has_candidate = torch.any(candidate, dim=-1)
    coop = eligible & has_candidate & nonempty
    pdist = torch.gather(d, 1, partner[:, None])[:, 0]
    return _decision(coop, partner, pdist, SELECTIVE_WEIGHTS)


def decide(
    rule: CoopRule, fog_pos: torch.Tensor, cluster_size: torch.Tensor,
    cparams: ch.ChannelParams,
) -> CoopDecision:
    """Dispatch on the cooperation rule."""
    if rule is CoopRule.NOCOOP:
        return no_cooperation(fog_pos)
    if rule is CoopRule.NEAREST:
        return nearest_cooperation(fog_pos, cluster_size, cparams)
    if rule is CoopRule.SELECTIVE:
        return selective_cooperation(fog_pos, cluster_size, cparams)
    raise ValueError(f"unknown cooperation rule: {rule}")

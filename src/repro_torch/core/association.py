"""Feasibility-aware association rules (paper Sec. IV-E / V-B).

Flat FL: only sensors with a feasible direct sensor->gateway link
participate.  Hierarchical FL: each sensor attaches to its *nearest
feasible* fog node; sensors with no feasible fog are inactive that round
(and get fog 0, the argmin of an all-inf row).  With the drift layer the
assignment can be frozen between re-associations, and the ``assigned_*``
rules recompute the live physics against it.  Every rule takes a
deployment with leading trial axes (``Deployment.stack``) and keeps them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import channel as ch
from repro_torch.core.topology import Deployment


class FlatAssociation(NamedTuple):
    """Direct-to-gateway association result."""

    participates: torch.Tensor   # (N,) bool — feasible direct gateway link
    dist_m: torch.Tensor         # (N,) sensor->gateway distance


class FogAssociation(NamedTuple):
    """Nearest-feasible-fog association result."""

    fog_id: torch.Tensor         # (N,) int32 — assigned fog (0 if inactive)
    participates: torch.Tensor   # (N,) bool — at least one feasible fog link
    dist_m: torch.Tensor         # (N,) distance to assigned fog
    cluster_size: torch.Tensor   # (M,) int32 — |C_m|
    fog_gateway_dist_m: torch.Tensor    # (M,) fog->gateway distance
    fog_gateway_feasible: torch.Tensor  # (M,) bool


def cluster_sizes(fog_id: torch.Tensor, member: torch.Tensor, n_fog: int) -> torch.Tensor:
    """(..., n_fog) int32 count of the members (``member`` (..., N) bool)
    of each fog, per trial of the leading axes."""
    out = torch.zeros(fog_id.shape[:-1] + (n_fog,), dtype=torch.int32, device=fog_id.device)
    return out.scatter_add_(-1, fog_id.long(), member.to(torch.int32))


def flat_association(dep: Deployment, cparams: ch.ChannelParams) -> FlatAssociation:
    """Sensors that can reach the gateway directly under the SL cap."""
    d = ch.norm(dep.sensor_pos - dep.gateway_pos[..., None, :])
    return FlatAssociation(participates=ch.feasible(d, cparams), dist_m=d)


def nearest_feasible_fog(dep: Deployment, cparams: ch.ChannelParams) -> FogAssociation:
    """Attach each sensor to its nearest feasible fog (paper Sec. V-B)."""
    d_sf = ch.pairwise_distances(dep.sensor_pos, dep.fog_pos)   # (..., N, M)
    feas = ch.feasible(d_sf, cparams)
    masked = torch.where(feas, d_sf, torch.inf)
    fog_id = torch.argmin(masked, dim=-1)
    participates = torch.any(feas, dim=-1)
    dist = torch.gather(d_sf, -1, fog_id[..., None])[..., 0]
    cluster_size = cluster_sizes(fog_id, participates, dep.fog_pos.shape[-2])
    d_fg = ch.norm(dep.fog_pos - dep.gateway_pos[..., None, :])
    return FogAssociation(
        fog_id=fog_id.to(torch.int32),
        participates=participates,
        dist_m=dist,
        cluster_size=cluster_size,
        fog_gateway_dist_m=d_fg,
        fog_gateway_feasible=ch.feasible(d_fg, cparams),
    )


def assigned_fog_association(
    dep: Deployment,
    cparams: ch.ChannelParams,
    fog_id: torch.Tensor,      # (N,) int32, frozen assignment
    assigned: torch.Tensor,    # (N,) bool, had a feasible fog at assignment
) -> FogAssociation:
    """Stale assignment, live physics (the drift layer).

    Distances, SNR feasibility, cluster sizes and fog-gateway links from
    the CURRENT geometry against a FROZEN sensor->fog assignment: a sensor
    whose assigned fog drifted out of range drops out until the next
    re-association.  Fresh from :func:`nearest_feasible_fog` on the same
    deployment it gives that function's result bit for bit (the distance
    takes the ops of ``ch.pairwise_distances``).
    """
    diff = dep.sensor_pos - torch.take_along_dim(dep.fog_pos, fog_id.long()[..., None], dim=-2)
    d = torch.sqrt(torch.sum(torch.square(diff), dim=-1) + 1e-12)
    participates = assigned & ch.feasible(d, cparams)
    cluster_size = cluster_sizes(fog_id, participates, dep.fog_pos.shape[-2])
    d_fg = ch.norm(dep.fog_pos - dep.gateway_pos[..., None, :])
    return FogAssociation(
        fog_id=fog_id.to(torch.int32),
        participates=participates,
        dist_m=d,
        cluster_size=cluster_size,
        fog_gateway_dist_m=d_fg,
        fog_gateway_feasible=ch.feasible(d_fg, cparams),
    )


def assigned_flat_association(
    dep: Deployment, cparams: ch.ChannelParams, assigned: torch.Tensor,
) -> FlatAssociation:
    """Flat-FL sibling of :func:`assigned_fog_association`: frozen round
    membership, live gateway distance and feasibility."""
    d = ch.norm(dep.sensor_pos - dep.gateway_pos[..., None, :])
    return FlatAssociation(participates=assigned & ch.feasible(d, cparams), dist_m=d)

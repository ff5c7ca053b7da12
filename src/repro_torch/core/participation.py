"""Participation accounting (paper contribution #1, Sec. VI-C).

The paper's central evaluation point: report *who can train* alongside
accuracy and energy.  These helpers compute, per round and per method
family, the participation fraction and reachability statistics that the
scalability study (Fig. 5, Table III) plots.  Every function takes
leading trial axes (a deployment from ``Deployment.stack``) and keeps
them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import association as assoc
from repro_torch.core import channel as ch
from repro_torch.core.topology import Deployment


class Reachability(NamedTuple):
    direct_gateway: torch.Tensor   # fraction of sensors with feasible direct link
    fog_assisted: torch.Tensor     # fraction with >= 1 feasible fog link
    fog_to_gateway: torch.Tensor   # fraction of fogs that can reach the gateway


def reachability(dep: Deployment, cparams: ch.ChannelParams) -> Reachability:
    flat = assoc.flat_association(dep, cparams)
    fog = assoc.nearest_feasible_fog(dep, cparams)
    return Reachability(
        direct_gateway=participation_fraction(flat.participates),
        fog_assisted=participation_fraction(fog.participates),
        fog_to_gateway=participation_fraction(fog.fog_gateway_feasible),
    )


def participation_fraction(mask: torch.Tensor) -> torch.Tensor:
    """Fraction of sensors contributing updates this round (over the last
    axis)."""
    return torch.mean(mask.to(torch.float32), dim=-1)


def energy_per_participant(total_energy_j: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Energy normalised by the number of *participating* sensors — the
    per-participant metric from the paper's design rule #1 (Sec. VI-G)."""
    return total_energy_j / torch.clamp_min(torch.sum(mask.to(torch.float32), dim=-1), 1.0)

"""Server-side adaptive optimiser for federated aggregation (FedAdam,
Reddi et al., ICLR'21 — the paper's related-work family [34]).

The aggregated client update acts as a pseudo-gradient at the gateway:
    theta_{t+1} = theta_t + server_opt(mean_delta).
Plain FedAvg is the identity server optimiser.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.channel import per_trial


class ServerOptState(NamedTuple):
    m: torch.Tensor       # (d,) or (B, d) first moment
    v: torch.Tensor       # (d,) or (B, d) second moment
    step: torch.Tensor    # () int32


def init_state(d: int | tuple[int, ...], device: torch.device | str = "cpu") -> ServerOptState:
    """Zero moments of shape ``d`` ((d,), or (B, d) for a batch of trials:
    Adam is elementwise, so the trials share only the step count)."""
    shape = (d,) if isinstance(d, int) else tuple(d)
    return ServerOptState(
        m=torch.zeros(shape, dtype=torch.float32, device=device),
        v=torch.zeros(shape, dtype=torch.float32, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def adam_update(
    pseudo_grad: torch.Tensor,
    state: ServerOptState,
    lr: float = 1e-2,
    b1: float = 0.9,
    b2: float = 0.99,
    eps: float = 1e-8,
) -> tuple[torch.Tensor, ServerOptState]:
    """One FedAdam step; returns (parameter increment, new state).  ``lr``
    may be a (B,) tensor, each trial of (B, d) moments its own rate."""
    step = state.step + 1
    m = b1 * state.m + (1.0 - b1) * pseudo_grad
    v = b2 * state.v + (1.0 - b2) * torch.square(pseudo_grad)
    t = step.to(torch.float32)
    mhat = m / (1.0 - torch.pow(b1, t))
    vhat = v / (1.0 - torch.pow(b2, t))
    incr = per_trial(lr, mhat) * mhat / (torch.sqrt(vhat) + eps)
    return incr, ServerOptState(m, v, step)

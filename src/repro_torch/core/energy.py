"""SNR-driven energy model (paper Sec. III-D, Eqs. 5-8) and battery dynamics.

All functions broadcast over link tensors.  Infeasible links (SL_min >
SL_max) get ``inf`` energy so downstream argmin/feasibility masks compose
naturally.  As in ``core/channel``, every parameter and a payload size
may be a (B,) tensor of per-trial values against (B, ...) link tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core import channel as ch


@dataclasses.dataclass(frozen=True)
class EnergyParams:
    """Energy parameters (paper Table II baseline)."""

    eta_ea: float = 0.25          # electro-acoustic efficiency
    p_circuit_tx_w: float = 0.05  # transmit circuit power (W)
    p_circuit_rx_w: float = 0.03  # receive circuit power (W)
    e_init_j: float = 500.0       # initial per-sensor battery (J)
    e_min_j: float = 0.0          # minimum battery reserve (Eq. 25)
    eps_op_j: float = 1e-9        # energy per FLOP for local compute (Sec. III-D)


def acoustic_power_w(sl_min_db: torch.Tensor) -> torch.Tensor:
    """Acoustic transmit power P_ac from source level (Eq. 7)."""
    coef = 4.0 * math.pi * ch.P_REF_PA**2 / (ch.RHO_WATER * ch.SOUND_SPEED_M_S)
    return coef * torch.pow(10.0, sl_min_db / 10.0)


def electrical_tx_power_w(sl_min_db: torch.Tensor, eparams: EnergyParams) -> torch.Tensor:
    """Electrical transmit power P_tx = P_ac / eta_ea (Sec. III-D)."""
    return acoustic_power_w(sl_min_db) / ch.per_trial(eparams.eta_ea, sl_min_db)


def tx_energy_j(
    bits: Any,
    dist_m: Any,
    cparams: ch.ChannelParams,
    eparams: EnergyParams,
) -> torch.Tensor:
    """Energy to transmit ``bits`` over distance ``dist_m`` (Eq. 8),
    power-controlled to gamma_tgt; infeasible links return ``inf``."""
    sl_min = ch.min_source_level_db(dist_m, cparams)
    p_tx = electrical_tx_power_w(sl_min, eparams)
    rate = ch.per_trial(ch.shannon_rate_bps(cparams), sl_min)
    p_circ = ch.per_trial(eparams.p_circuit_tx_w, sl_min)
    e = (p_tx + p_circ) * ch.per_trial(ch.f32(bits), sl_min) / rate
    return torch.where(sl_min <= ch.per_trial(cparams.sl_max_db, sl_min), e, math.inf)


def rx_energy_j(bits: Any, cparams: ch.ChannelParams, eparams: EnergyParams) -> torch.Tensor:
    """Receive energy E_rx = P_c,rx * L / R (Sec. III-D)."""
    rate = ch.shannon_rate_bps(cparams)
    return eparams.p_circuit_rx_w * ch.f32(bits) / rate


def compute_energy_j(flops: Any, eparams: EnergyParams) -> torch.Tensor:
    """Local-training compute energy E_comp = eps_op * Phi (Sec. III-D)."""
    return eparams.eps_op_j * ch.f32(flops)


def link_latency_s(bits: Any, dist_m: Any, cparams: ch.ChannelParams) -> torch.Tensor:
    """Per-link latency tau = d/c_s + L/R (Eq. 21 inner term)."""
    rate = ch.shannon_rate_bps(cparams)
    delay = ch.propagation_delay_s(dist_m)
    return delay + ch.per_trial(ch.f32(bits) / rate, delay)


def battery_step(
    residual_j: torch.Tensor, spent_j: torch.Tensor, eparams: EnergyParams,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One round of battery depletion (Sec. IV-C): (new residual floored at
    the reserve, alive mask of Eq. 25)."""
    new = residual_j - spent_j
    floor = ch.per_trial(eparams.e_min_j, new)
    alive = new >= floor
    if isinstance(floor, torch.Tensor):
        return torch.maximum(new, floor), alive
    return torch.clamp_min(new, floor), alive


def autoencoder_flops(d_in: int, hidden: tuple[int, ...], n_samples: int, epochs: int) -> int:
    """FLOPs for E epochs of AE training (fwd+bwd ~= 3x fwd matmul cost)."""
    dims = (d_in, *hidden, d_in)
    mm = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    return 3 * mm * n_samples * epochs

"""Underwater acoustic channel model (paper Sec. III-B/C).

Every function accepts Python numbers or tensors and broadcasts; link
quantities are f32 tensors, as in ``repro.core.channel``:

  - transmission loss  TL(d, f) = 10 k log10(d) + alpha(f) d/1000      (Eq. 1)
  - Thorp absorption   alpha(f) in dB/km, f in kHz                     (Eq. 2)
  - Wenz ambient noise PSD, four components combined in linear scale   (Eq. 3)
  - passive-sonar SNR  SNR = SL - TL - NL - IL                         (Eq. 4)

Functions of the parameters alone return 0-d CPU tensors, which combine
with tensors on any device.

Every parameter may also be a (B,) tensor of per-trial values (a config
sweep's knob, ``Engine.sweep``): a function of the parameters alone then
returns (B,), and :func:`per_trial` views such a value as (B, 1, ...)
against a (B, N) or (B, N, M) operand.  A Python float keeps the
arithmetic of a one-trial config exactly as it was.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

SOUND_SPEED_M_S = 1500.0
P_REF_PA = 1e-6
RHO_WATER = 1025.0

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ChannelParams:
    """Acoustic parameters (paper Table II baseline)."""

    freq_khz: float = 12.0          # carrier frequency f (kHz)
    bandwidth_hz: float = 4000.0    # receiver bandwidth B (Hz)
    spreading_k: float = 1.5        # spreading factor k
    wind_m_s: float = 5.0           # wind speed w (m/s)
    shipping: float = 0.5           # shipping activity s in [0, 1]
    gamma_tgt_db: float = 10.0      # target operating SNR (dB)
    impl_loss_db: float = 2.0       # implementation loss IL (dB)
    sl_max_db: float = 140.0        # capped source level (dB re 1 uPa @ 1 m)

    def replace(self, **kw: Any) -> "ChannelParams":
        return dataclasses.replace(self, **kw)


def f32(x: Any) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32)


def per_trial(knob: Any, operand: torch.Tensor) -> Any:
    """``knob`` ready to meet ``operand``: a (B,) tensor of per-trial
    values viewed as (B, 1, ...) to the operand's rank; a number, a 0-d
    tensor, or a (B,) tensor against a (B,) or 0-d operand as it is."""
    if isinstance(knob, torch.Tensor) and knob.dim() == 1 and operand.dim() > 1:
        return knob.view((-1,) + (1,) * (operand.dim() - 1))
    return knob


def thorp_absorption_db_per_km(f_khz: Any) -> torch.Tensor:
    """Thorp absorption coefficient alpha(f) in dB/km, f in kHz (Eq. 2)."""
    f2 = torch.square(f32(f_khz))
    return 0.11 * f2 / (1.0 + f2) + 44.0 * f2 / (4100.0 + f2) + 2.75e-4 * f2 + 0.003


def transmission_loss_db(dist_m: Any, f_khz: float, spreading_k: float = 1.5) -> torch.Tensor:
    """Large-scale transmission loss TL(d, f) in dB (Eq. 1); ``dist_m`` is
    clipped at the 1 m source-level reference distance."""
    d = torch.clamp_min(f32(dist_m), 1.0)
    alpha = per_trial(thorp_absorption_db_per_km(f_khz), d)
    return 10.0 * per_trial(spreading_k, d) * torch.log10(d) + alpha * d / 1000.0


def wenz_noise_psd_db(f_khz: float, wind_m_s: float = 5.0, shipping: float = 0.5) -> torch.Tensor:
    """Wenz-type ambient-noise PSD N0(f) in dB re 1 uPa^2/Hz (Eq. 3), with
    Stojanovic's component formulae (turbulence, shipping, wind, thermal)."""
    f = f32(f_khz)
    logf = torch.log10(f)
    n_turb = 17.0 - 30.0 * logf
    n_ship = 40.0 + 20.0 * (shipping - 0.5) + 26.0 * logf - 60.0 * torch.log10(f + 0.03)
    n_wind = 50.0 + 7.5 * torch.sqrt(f32(wind_m_s)) + 20.0 * logf - 40.0 * torch.log10(f + 0.4)
    n_therm = -15.0 + 20.0 * logf
    parts = (n_turb, n_ship, n_wind, n_therm)
    if len({p.device for p in parts}) == 1:
        stacked = torch.stack(torch.broadcast_tensors(*parts))
        return 10.0 * torch.log10(torch.sum(torch.pow(10.0, stacked / 10.0), dim=0))
    # A (B,) knob on the card beside the CPU scalars: the same four terms
    # added in order, with no copy of a scalar to the card.
    total = torch.pow(10.0, n_turb / 10.0)
    for p in parts[1:]:
        total = total + torch.pow(10.0, p / 10.0)
    return 10.0 * torch.log10(total)


def noise_level_db(params: ChannelParams) -> torch.Tensor:
    """Band noise level NL(f, B) = N0(f) + 10 log10 B (Sec. III-C)."""
    n0 = wenz_noise_psd_db(params.freq_khz, params.wind_m_s, params.shipping)
    return n0 + 10.0 * torch.log10(f32(params.bandwidth_hz))


def snr_db(sl_db: Any, dist_m: Any, params: ChannelParams) -> torch.Tensor:
    """Receiver SNR via the passive sonar equation (Eq. 4), DI = 0."""
    tl = transmission_loss_db(dist_m, params.freq_khz, params.spreading_k)
    nl = per_trial(noise_level_db(params), tl)
    return sl_db - tl - nl - per_trial(params.impl_loss_db, tl)


def min_source_level_db(dist_m: Any, params: ChannelParams) -> torch.Tensor:
    """Minimum source level to hit gamma_tgt at distance d (Eq. 5)."""
    tl = transmission_loss_db(dist_m, params.freq_khz, params.spreading_k)
    nl = per_trial(noise_level_db(params), tl)
    return per_trial(params.gamma_tgt_db, tl) + tl + nl + per_trial(params.impl_loss_db, tl)


def feasible(dist_m: Any, params: ChannelParams) -> torch.Tensor:
    """Capped-source-level feasibility SL_min <= SL_max (Eq. 6). Boolean."""
    sl = min_source_level_db(dist_m, params)
    return sl <= per_trial(params.sl_max_db, sl)


def shannon_rate_bps(params: ChannelParams) -> torch.Tensor:
    """Shannon-type link rate at the target operating SNR (Sec. III-D)."""
    g = params.gamma_tgt_db
    gamma_lin = torch.pow(10.0, g / 10.0) if isinstance(g, torch.Tensor) else 10.0 ** (g / 10.0)
    return params.bandwidth_hz * torch.log2(f32(1.0 + gamma_lin))


def propagation_delay_s(dist_m: Any) -> torch.Tensor:
    """Acoustic propagation delay tau = d / c_s (Sec. III-B)."""
    return f32(dist_m) / SOUND_SPEED_M_S


def pairwise_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distance matrix between position sets a:(..., N, 3) and
    b:(..., M, 3): (..., N, M), leading (trial) axes broadcast."""
    diff = a[..., :, None, :] - b[..., None, :, :]
    return torch.sqrt(torch.sum(torch.square(diff), dim=-1) + 1e-12)


def norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, as ``jnp.linalg.norm`` sums it."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


def max_feasible_range_m(params: ChannelParams, hi_m: float = 50_000.0) -> torch.Tensor:
    """Maximum feasible link distance under the SL cap: TL is monotone in
    d, so 64 bisection steps pin the feasibility threshold."""
    lo, hi = f32(1.0), f32(hi_m)
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        ok = feasible(mid, params)
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo

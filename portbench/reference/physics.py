"""Round physics of the reference: fog mobility, the acoustic channel, the
energy model, association and the cooperation decision (paper Sec. III,
IV-E, V-B; Eqs. 1-8, 14, 17-21, 28-29).

Frozen copy, at commit 503575e07401e7f10a9c0026dea9d563d82ebbba, of the
one-trial-config arithmetic of ``src/repro_torch/core/{topology,channel,
energy,association,cooperation}.py``, op for op, so that a round's
participation, cooperation and energies come out the same bits as the
program's on the same device.  Parameters are the configuration file's
``channel``, ``energy`` and ``deployment`` groups (plain dicts); every
tensor may lead with a trial axis.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32
SOUND_SPEED_M_S = 1500.0
P_REF_PA = 1e-6
RHO_WATER = 1025.0
SELECTIVE_WEIGHTS = (0.8, 0.2)    # Eq. 29
NEAREST_WEIGHTS = (0.7, 0.3)
ELIGIBILITY_FACTOR = 0.75         # Eq. 28


def f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32)


# --- channel (Eqs. 1-6) ------------------------------------------------------

def thorp_db_per_km(f_khz) -> torch.Tensor:
    f2 = torch.square(f32(f_khz))
    return 0.11 * f2 / (1.0 + f2) + 44.0 * f2 / (4100.0 + f2) + 2.75e-4 * f2 + 0.003


def transmission_loss_db(dist_m, ch: dict) -> torch.Tensor:
    d = torch.clamp_min(f32(dist_m), 1.0)
    return (10.0 * ch["spreading_k"] * torch.log10(d)
            + thorp_db_per_km(ch["freq_khz"]) * d / 1000.0)


def noise_level_db(ch: dict) -> torch.Tensor:
    f = f32(ch["freq_khz"])
    logf = torch.log10(f)
    parts = (17.0 - 30.0 * logf,
             40.0 + 20.0 * (ch["shipping"] - 0.5) + 26.0 * logf - 60.0 * torch.log10(f + 0.03),
             50.0 + 7.5 * torch.sqrt(f32(ch["wind_m_s"])) + 20.0 * logf
             - 40.0 * torch.log10(f + 0.4),
             -15.0 + 20.0 * logf)
    stacked = torch.stack(torch.broadcast_tensors(*parts))
    n0 = 10.0 * torch.log10(torch.sum(torch.pow(10.0, stacked / 10.0), dim=0))
    return n0 + 10.0 * torch.log10(f32(ch["bandwidth_hz"]))


def min_source_level_db(dist_m, ch: dict) -> torch.Tensor:
    tl = transmission_loss_db(dist_m, ch)
    return ch["gamma_tgt_db"] + tl + noise_level_db(ch) + ch["impl_loss_db"]


def feasible(dist_m, ch: dict) -> torch.Tensor:
    return min_source_level_db(dist_m, ch) <= ch["sl_max_db"]


def shannon_rate_bps(ch: dict) -> torch.Tensor:
    return ch["bandwidth_hz"] * torch.log2(f32(1.0 + 10.0 ** (ch["gamma_tgt_db"] / 10.0)))


def pairwise_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    diff = a[..., :, None, :] - b[..., None, :, :]
    return torch.sqrt(torch.sum(torch.square(diff), dim=-1) + 1e-12)


def norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


# --- energy (Eqs. 7-8, 21) ---------------------------------------------------

def tx_energy_j(bits, dist_m, ch: dict, en: dict) -> torch.Tensor:
    """Energy to send ``bits`` over ``dist_m`` at the target SNR; ``inf``
    on an infeasible link."""
    sl_min = min_source_level_db(dist_m, ch)
    coef = 4.0 * math.pi * P_REF_PA**2 / (RHO_WATER * SOUND_SPEED_M_S)
    p_tx = coef * torch.pow(10.0, sl_min / 10.0) / en["eta_ea"]
    e = (p_tx + en["p_circuit_tx_w"]) * f32(bits) / shannon_rate_bps(ch)
    return torch.where(sl_min <= ch["sl_max_db"], e, math.inf)


def link_latency_s(bits, dist_m, ch: dict) -> torch.Tensor:
    delay = f32(dist_m) / SOUND_SPEED_M_S
    return delay + f32(bits) / shannon_rate_bps(ch)


def autoencoder_flops(dims: tuple[int, ...], n_samples: int, epochs: int) -> int:
    """FLOPs of E epochs of AE training (forward and backward ~ 3x the
    forward matmuls), the compute cost the paper charges a client."""
    mm = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    return 3 * mm * n_samples * epochs


# --- fog mobility (Sec. III-A) -----------------------------------------------

def _box(dep: dict, depth, device):
    lo = torch.tensor([0.0, 0.0, depth[0]], dtype=F32).to(device)
    hi = torch.tensor([dep["lx_m"], dep["ly_m"], depth[1]], dtype=F32).to(device)
    return lo, hi


def gauss_markov_step(noise, fog_pos, fog_vel, dep: dict):
    """One Gauss-Markov drift of the fogs, reflected into their stratum:
    (positions, velocities)."""
    a = dep["gm_alpha"]
    noise = noise * dep["fog_speed_m_s"]
    root = torch.sqrt(torch.tensor(max(1.0 - a * a, 0.0), dtype=F32))
    vel = a * fog_vel + root * noise
    pos = fog_pos + vel * dep["round_interval_s"]
    lo, hi = _box(dep, dep["fog_depth"], pos.device)
    over_hi, under_lo = pos > hi, pos < lo
    pos = torch.where(over_hi, 2.0 * hi - pos, pos)
    pos = torch.where(under_lo, 2.0 * lo - pos, pos)
    pos = torch.minimum(torch.maximum(pos, lo), hi)
    return pos, torch.where(over_hi | under_lo, -vel, vel)


# --- association (Sec. V-B) --------------------------------------------------

def cluster_sizes(fog_id: torch.Tensor, member: torch.Tensor, n_fog: int) -> torch.Tensor:
    out = torch.zeros(fog_id.shape[:-1] + (n_fog,), dtype=torch.int32, device=fog_id.device)
    return out.scatter_add_(-1, fog_id.long(), member.to(torch.int32))


def nearest_feasible_fog(sensor_pos, fog_pos, gateway_pos, ch: dict) -> dict:
    """Each sensor's nearest feasible fog (fog 0 and no participation when
    it has none), its distance, and each fog's gateway link."""
    d_sf = pairwise_distances(sensor_pos, fog_pos)
    feas = feasible(d_sf, ch)
    fog_id = torch.argmin(torch.where(feas, d_sf, torch.inf), dim=-1)
    d_fg = norm(fog_pos - gateway_pos[..., None, :])
    return dict(fog_id=fog_id.to(torch.int32), participates=torch.any(feas, dim=-1),
                dist_m=torch.gather(d_sf, -1, fog_id[..., None])[..., 0],
                fog_gateway_dist_m=d_fg, fog_gateway_feasible=feasible(d_fg, ch))


# --- cooperation (Eqs. 14, 28-29) ---------------------------------------------

def _decision(coop, partner, dist, weights) -> dict:
    idx = torch.arange(coop.shape[-1], device=coop.device)
    w_self, w_peer = weights
    return dict(partner=torch.where(coop, partner, idx),
                self_weight=torch.where(coop, w_self, 1.0).to(F32),
                partner_weight=torch.where(coop, w_peer, 0.0).to(F32),
                cooperates=coop, dist_m=torch.where(coop, dist, 0.0))


def _fog_distances(fog_pos):
    d = pairwise_distances(fog_pos, fog_pos)
    return d + torch.diag(torch.full((fog_pos.shape[-2],), torch.inf, device=d.device))


def cooperation(rule: str, fog_pos, cluster_size, ch: dict) -> dict:
    """Each fog's partner and mixing weights under ``rule`` (``nocoop``,
    ``nearest`` or ``selective``)."""
    if rule == "nocoop":
        shape, dev = tuple(fog_pos.shape[:-1]), fog_pos.device
        return dict(partner=torch.arange(shape[-1], device=dev).expand(shape),
                    self_weight=torch.ones(shape, dtype=F32, device=dev),
                    partner_weight=torch.zeros(shape, dtype=F32, device=dev),
                    cooperates=torch.zeros(shape, dtype=torch.bool, device=dev),
                    dist_m=torch.zeros(shape, dtype=F32, device=dev))
    d = _fog_distances(fog_pos)
    if rule == "nearest":
        nonempty = cluster_size > 0
        feas = feasible(d, ch) & nonempty[..., None, :]
        partner = torch.argmin(torch.where(feas, d, torch.inf), dim=-1)
        has_any = torch.any(feas, dim=-1) & nonempty
        return _decision(has_any, partner, torch.gather(d, -1, partner[..., None])[..., 0],
                         NEAREST_WEIGHTS)
    if rule != "selective":
        raise ValueError(f"unknown cooperation rule {rule!r}")
    feas = feasible(d, ch)
    c = cluster_size.to(F32)
    nonempty = c > 0
    ne = nonempty.to(F32)
    mean_c = torch.sum(c * ne, dim=-1) / torch.clamp_min(torch.sum(ne, dim=-1), 1.0)
    eligible = c <= torch.clamp_min(ELIGIBILITY_FACTOR * mean_c[..., None], 2.0)
    any_feasible = torch.any(feas.flatten(-2), dim=-1)
    feas_d = torch.where(feas, d, torch.nan)
    q1 = torch.nanquantile(torch.where(any_feasible[..., None, None], feas_d, 0.0).flatten(-2),
                           0.25, dim=-1)
    larger = (c[..., None, :] > c[..., :, None]) & nonempty[..., None, :]
    candidate = feas & larger & (d < q1[..., None, None])
    partner = torch.argmin(torch.where(candidate, d, torch.inf), dim=-1)
    coop = eligible & torch.any(candidate, dim=-1) & nonempty
    return _decision(coop, partner, torch.gather(d, -1, partner[..., None])[..., 0],
                     SELECTIVE_WEIGHTS)

"""3D stratified IoUT deployment and fog mobility (paper Sec. III-A).

Sensors are static and deep; fog nodes are mid-water and drift between
rounds with a Gauss-Markov mobility model.  The surface gateway sits at
z = 0 in the centre of the deployment area.  Randomness is an argument:
:func:`sample_deployment` draws from a ``torch.Generator`` and
:func:`gauss_markov_step` takes its standard-normal noise, so a test can
feed both packages the same draws.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import device as _device

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class DeploymentParams:
    """Geometry parameters (paper Table II baseline)."""

    lx_m: float = 2000.0
    ly_m: float = 2000.0
    depth_m: float = 1000.0
    n_sensors: int = 100
    n_fog: int = 10
    sensor_depth: tuple[float, float] = (500.0, 1000.0)
    fog_depth: tuple[float, float] = (100.0, 400.0)
    # Gauss-Markov fog drift
    fog_speed_m_s: float = 0.5
    gm_alpha: float = 0.75       # memory factor
    round_interval_s: float = 60.0


@dataclasses.dataclass
class Deployment:
    """Dynamic node state: positions and fog velocities (f32)."""

    sensor_pos: torch.Tensor      # (N, 3)
    fog_pos: torch.Tensor         # (M, 3)
    fog_vel: torch.Tensor         # (M, 3)
    gateway_pos: torch.Tensor     # (3,)

    def to(self, device: torch.device | str) -> "Deployment":
        return Deployment(*(t.to(device) for t in dataclasses.astuple(self)))


def _box(params: DeploymentParams, depth: tuple[float, float], device) -> tuple:
    lo = torch.tensor([0.0, 0.0, depth[0]], dtype=F32, device=device)
    hi = torch.tensor([params.lx_m, params.ly_m, depth[1]], dtype=F32, device=device)
    return lo, hi


def sample_deployment(
    generator: torch.Generator, params: DeploymentParams,
    *, device: torch.device | str | None = None,
) -> Deployment:
    """A fresh deployment: uniform (x, y) and uniform depth per stratum.
    Draw order: ``rand(N, 3)`` for the sensors, then ``rand(M, 3)`` for
    the fogs, each column scaled to its range (on the CPU, then moved)."""
    dev = _device.resolve(device)
    pos = []
    for n, depth in ((params.n_sensors, params.sensor_depth), (params.n_fog, params.fog_depth)):
        lo, hi = _box(params, depth, "cpu")
        pos.append(lo + (hi - lo) * torch.rand((n, 3), generator=generator, dtype=F32))
    gateway = torch.tensor([params.lx_m / 2.0, params.ly_m / 2.0, 0.0], dtype=F32)
    dep = Deployment(pos[0], pos[1], torch.zeros((params.n_fog, 3), dtype=F32), gateway)
    return dep.to(dev)


def gauss_markov_step(
    noise: torch.Tensor, dep: Deployment, params: DeploymentParams,
) -> Deployment:
    """Drift fog nodes one round with a Gauss-Markov mobility model.

    v_{t+1} = a v_t + sqrt(1-a^2) sigma w, with ``noise`` = w ~ N(0, I) of
    shape (M, 3).  Positions reflect into the deployment volume and are
    clamped to the fog stratum's depth band; a reflected component flips
    its velocity.
    """
    a = params.gm_alpha
    noise = noise * params.fog_speed_m_s
    root = torch.sqrt(torch.tensor(max(1.0 - a * a, 0.0), dtype=F32))
    vel = a * dep.fog_vel + root * noise
    pos = dep.fog_pos + vel * params.round_interval_s
    lo, hi = _box(params, params.fog_depth, pos.device)
    over_hi = pos > hi
    under_lo = pos < lo
    pos = torch.where(over_hi, 2.0 * hi - pos, pos)
    pos = torch.where(under_lo, 2.0 * lo - pos, pos)
    pos = torch.minimum(torch.maximum(pos, lo), hi)  # guard double reflection
    vel = torch.where(over_hi | under_lo, -vel, vel)
    return Deployment(dep.sensor_pos, pos, vel, dep.gateway_pos)

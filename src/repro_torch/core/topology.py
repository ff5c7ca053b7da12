"""3D stratified IoUT deployment and fog mobility (paper Sec. III-A).

Sensors are deep and, with the drift layer (``core/drift``), ride a
depth-sheared current; fog nodes are mid-water and drift between rounds
with a Gauss-Markov mobility model.  The surface gateway sits at
z = 0 in the centre of the deployment area.  Randomness is an argument:
:func:`sample_deployment` draws from a ``torch.Generator`` and
:func:`gauss_markov_step` takes its standard-normal noise, so a test can
feed both packages the same draws.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
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
    """Dynamic node state: positions and fog velocities (f32).  A batch of
    trials carries a leading trial axis on every field (``stack``)."""

    sensor_pos: torch.Tensor      # (N, 3)
    fog_pos: torch.Tensor         # (M, 3)
    fog_vel: torch.Tensor         # (M, 3)
    gateway_pos: torch.Tensor     # (3,)

    def to(self, device: torch.device | str) -> "Deployment":
        return Deployment(*(t.to(device) for t in dataclasses.astuple(self)))

    @staticmethod
    def stack(deps: "list[Deployment]") -> "Deployment":
        """Deployments stacked along a new leading trial axis."""
        return Deployment(*(torch.stack([getattr(dep, f.name) for dep in deps])
                            for f in dataclasses.fields(Deployment)))


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
    shape (M, 3) (or (B, M, 3) for a batch of trials).  Positions reflect
    into the deployment volume and are clamped to the fog stratum's depth
    band; a reflected component flips its velocity.
    """
    a = params.gm_alpha
    noise = noise * params.fog_speed_m_s
    root = torch.sqrt(torch.tensor(max(1.0 - a * a, 0.0), dtype=F32))
    vel = a * dep.fog_vel + root * noise
    pos, flipped = _reflect(dep.fog_pos + vel * params.round_interval_s, params,
                            params.fog_depth)
    vel = torch.where(flipped, -vel, vel)
    return Deployment(dep.sensor_pos, pos, vel, dep.gateway_pos)


def _reflect(pos: torch.Tensor, params: DeploymentParams,
             depth: tuple[float, float]) -> tuple[torch.Tensor, torch.Tensor]:
    """Reflect positions into the deployment volume at the stratum
    ``depth``, then clamp (a guard against double reflection); returns
    (positions, the components that reflected)."""
    lo, hi = _box(params, depth, pos.device)
    over_hi = pos > hi
    under_lo = pos < lo
    pos = torch.where(over_hi, 2.0 * hi - pos, pos)
    pos = torch.where(under_lo, 2.0 * lo - pos, pos)
    return torch.minimum(torch.maximum(pos, lo), hi), over_hi | under_lo


def current_advection_step(
    dep: Deployment, params: DeploymentParams, speed_m_s: float,
) -> Deployment:
    """Advect the SENSORS one round interval in a depth-sheared current.

    The current is horizontal and deterministic: its direction turns with
    depth, ``(cos, sin)(2 pi z / depth_m)``, so co-located sensors at
    different depths separate over time.  The phase is computed as
    ``z * (f32(2 pi) * f32(1 / depth_m))``, the arithmetic XLA gives the
    reference's jitted ``2 pi z / depth_m`` (a true division rounds apart
    on most depths).  Positions reflect into the sensor stratum as the fog
    walk's do into theirs.
    """
    rate = float(np.float32(2.0 * math.pi) * (np.float32(1.0) / np.float32(params.depth_m)))
    s = float(np.float32(speed_m_s))
    z = dep.sensor_pos[..., 2]
    phase = z * rate
    vel = torch.stack([s * torch.cos(phase), s * torch.sin(phase), torch.zeros_like(z)], dim=-1)
    pos, _ = _reflect(dep.sensor_pos + vel * params.round_interval_s, params,
                      params.sensor_depth)
    return Deployment(pos, dep.fog_pos, dep.fog_vel, dep.gateway_pos)

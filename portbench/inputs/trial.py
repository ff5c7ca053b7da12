"""A trial's random inputs: initial autoencoder params, the deployment and
every round's draws.

Frozen copies, at commit 503575e07401e7f10a9c0026dea9d563d82ebbba, of
``src/repro_torch/models/autoencoder.py`` (``init``),
``src/repro_torch/core/topology.py`` (``sample_deployment``),
``src/repro_torch/data/pipeline.py`` (``multi_epoch_indices``) and
``src/repro_torch/core/hfl.py`` (``draw_rounds``), in their draw order, on
the generator's device.  Plain tensors and dicts: the harness hands them
to the program in its own types, and the reference reads them as they are.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

F32 = torch.float32


class Deployment(NamedTuple):
    sensor_pos: torch.Tensor      # (N, 3)
    fog_pos: torch.Tensor         # (M, 3)
    fog_vel: torch.Tensor         # (M, 3)
    gateway_pos: torch.Tensor     # (3,)


class Draws(NamedTuple):
    mobility: torch.Tensor                  # (T, M, 3) standard normals
    batches: torch.Tensor                   # (T, N, steps, bs) int32 row indices
    crash: torch.Tensor | None = None       # (T, N) uniforms (fault layer on)
    erase: torch.Tensor | None = None       # (T, N) uniforms (fault layer on)
    byz_noise: torch.Tensor | None = None   # (T, N, d) normals (Gaussian Byzantine)


def init_params(g: torch.Generator, dims: tuple[int, ...]) -> list[dict]:
    """Glorot-normal weights, zero biases: ``[{"w": (a, b), "b": (b,)}]``."""
    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        scale = math.sqrt(2.0 / (a + b))
        w = scale * torch.randn((a, b), generator=g, dtype=F32, device=g.device)
        params.append({"w": w, "b": torch.zeros((b,), device=g.device)})
    return params


def sample_deployment(g: torch.Generator, dep: dict) -> Deployment:
    """Uniform (x, y) and uniform depth in each stratum: ``rand(N, 3)``
    for the sensors, then ``rand(M, 3)`` for the fogs; the gateway at the
    surface centre, fog velocities zero."""
    dev = g.device
    pos = []
    for n, depth in ((dep["n_sensors"], dep["sensor_depth"]), (dep["n_fog"], dep["fog_depth"])):
        lo = torch.tensor([0.0, 0.0, depth[0]], dtype=F32, device=dev)
        hi = torch.tensor([dep["lx_m"], dep["ly_m"], depth[1]], dtype=F32, device=dev)
        pos.append(lo + (hi - lo) * torch.rand((n, 3), generator=g, dtype=F32, device=dev))
    gateway = torch.tensor([dep["lx_m"] / 2.0, dep["ly_m"] / 2.0, 0.0], dtype=F32, device=dev)
    return Deployment(pos[0], pos[1], torch.zeros((dep["n_fog"], 3), dtype=F32, device=dev),
                      gateway)


def multi_epoch_indices(g: torch.Generator, clients: int, n: int, batch_size: int,
                        epochs: int) -> torch.Tensor:
    """(clients, epochs * n//bs, bs) int32: each epoch's permutation of [0,
    n) is the argsort of ``n`` f64 uniforms, cut to whole minibatches."""
    nb = n // batch_size
    keys = torch.rand((clients, epochs, n), generator=g, dtype=torch.float64, device=g.device)
    perms = torch.argsort(keys, dim=-1)[..., : nb * batch_size]
    return perms.reshape(clients, epochs * nb, batch_size).to(torch.int32)


def draw_rounds(g: torch.Generator, rounds: int, n_fog: int, n: int, window: int,
                batch_size: int, epochs: int, faults: bool, gauss: bool, d: int) -> Draws:
    """Per round: ``randn(M, 3)`` mobility, the clients' index tables,
    then with the fault layer on ``rand(N)`` crash and ``rand(N)`` erasure
    uniforms and, for Gaussian Byzantine clients, ``randn(N, d)`` noise."""
    dev = g.device
    noise, batches, crash, erase, byz = [], [], [], [], []
    for _ in range(rounds):
        noise.append(torch.randn((n_fog, 3), generator=g, device=dev))
        batches.append(multi_epoch_indices(g, n, window, batch_size, epochs))
        if faults:
            crash.append(torch.rand((n,), generator=g, device=dev))
            erase.append(torch.rand((n,), generator=g, device=dev))
        if gauss:
            byz.append(torch.randn((n, d), generator=g, device=dev))
    return Draws(*(torch.stack(xs) if xs else None
                   for xs in (noise, batches, crash, erase, byz)))

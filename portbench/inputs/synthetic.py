"""Synthetic IoUT telemetry windows with injected anomalies.

Frozen copy of ``src/repro_torch/data/synthetic.py`` at commit
503575e07401e7f10a9c0026dea9d563d82ebbba (``generate``, ``normalize`` and
their helpers), drawing every tensor on the generator's device instead of
the host.  Each sensor's series is a Dirichlet mix of ``n_modes`` random
linear maps of a smooth latent process (sinusoids plus AR(1) drift) plus
noise; the test split carries three spike, ramp or stuck segments per
sensor, labelled.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class Telemetry(NamedTuple):
    """Per-sensor splits, leading axis = sensor (field for field the
    port's ``SensorDataset``)."""

    train: torch.Tensor        # (N, train_len, D) normal
    val: torch.Tensor          # (N, val_len, D) normal
    test: torch.Tensor         # (N, test_len, D) mixed
    test_label: torch.Tensor   # (N, test_len) bool
    n_samples: torch.Tensor    # (N,) f32 aggregation weights n_i


def _uniform(g: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=g.device)


def _latent_process(g: torch.Generator, n: int, length: int, dim: int) -> torch.Tensor:
    """(n, length, dim) smooth latents: sinusoids + AR(1) noise."""
    dev = g.device
    t = torch.arange(length, dtype=torch.float32, device=dev)[None, :, None]
    freq = _uniform(g, (n, 1, dim), 0.01, 0.1)
    phase = _uniform(g, (n, 1, dim), 0.0, 2.0 * math.pi)
    sin = torch.sin(2.0 * math.pi * freq * t + phase)
    noise = torch.randn((n, length, dim), generator=g, device=dev) * 0.3
    ar = torch.empty_like(noise)
    carry = torch.zeros((n, dim), device=dev)
    for s in range(length):
        carry = 0.9 * carry + noise[:, s]
        ar[:, s] = carry
    return sin + 0.2 * ar


def _inject_anomalies(g: torch.Generator, x: torch.Tensor, rate: float, scale: float):
    """Inject 3 anomaly segments per sensor; returns (x', labels)."""
    n, length, d = x.shape
    dev = g.device
    n_seg = 3
    seg_len = max(1, int(rate * length / n_seg))
    starts = torch.randint(0, max(1, length - seg_len), (n, n_seg), generator=g, device=dev)
    pos = torch.arange(length, device=dev)[None, None, :]
    label = ((pos >= starts[..., None]) & (pos < starts[..., None] + seg_len)).any(1)
    feat_mask = (torch.rand((n, 1, d), generator=g, device=dev) < 0.4).to(x.dtype)
    kind = torch.randint(0, 3, (n, 1, 1), generator=g, device=dev)
    mag = scale * (1.0 + torch.rand((n, 1, 1), generator=g, device=dev))
    spike = x + mag * feat_mask * torch.sign(torch.randn(x.shape, generator=g, device=dev))
    ramp = x + mag * feat_mask * torch.linspace(0.0, 1.0, length, device=dev)[None, :, None]
    stuck = torch.where(feat_mask > 0, x.mean(1, keepdim=True) + mag, x)
    anom = torch.where(kind == 0, spike, torch.where(kind == 1, ramp, stuck))
    return torch.where(label[..., None], anom, x), label


def generate(g: torch.Generator, data: dict) -> Telemetry:
    """A fleet's telemetry, z-scored per sensor by its train statistics,
    from the configuration's ``data`` group (``n_sensors``,
    ``feature_dim``, ``latent_dim``, ``n_modes``, ``train_len``,
    ``val_len``, ``test_len``, ``dirichlet_alpha``, ``anomaly_rate``,
    ``noise_std``, ``anomaly_scale``)."""
    dev = g.device
    n, dim = data["n_sensors"], data["feature_dim"]
    mode_maps = torch.randn((data["n_modes"], data["latent_dim"], dim), generator=g,
                            device=dev) / math.sqrt(data["latent_dim"])
    seed = int(torch.randint(0, 2**62, (1,), generator=g, device=dev))
    mix = torch.from_numpy(np.random.default_rng(seed).dirichlet(
        np.full(data["n_modes"], data["dirichlet_alpha"]), n)).to(torch.float32).to(dev)
    total = data["train_len"] + data["val_len"] + data["test_len"]
    latent = _latent_process(g, n, total, data["latent_dim"])
    obs_map = torch.einsum("nm,mld->nld", mix, mode_maps)            # (N, latent, D)
    x = latent @ obs_map + data["noise_std"] * torch.randn((n, total, dim), generator=g,
                                                           device=dev)
    train = x[:, : data["train_len"]]
    val = x[:, data["train_len"]: data["train_len"] + data["val_len"]]
    test, label = _inject_anomalies(g, x[:, data["train_len"] + data["val_len"]:],
                                    data["anomaly_rate"], data["anomaly_scale"])
    mean = torch.mean(train, dim=1, keepdim=True)
    std = torch.std(train, dim=1, keepdim=True, unbiased=False) + 1e-6
    return Telemetry(
        train=((train - mean) / std).contiguous(),
        val=((val - mean) / std).contiguous(),
        test=((test - mean) / std).contiguous(),
        test_label=label,
        n_samples=torch.full((n,), float(data["train_len"]), device=dev),
    )

"""Synthetic IoUT sensing data (paper Sec. III-E / VI evaluation substrate).

Each sensor produces a multivariate series x in R^D built from a small set
of latent environmental *modes* (water masses / equipment regimes): a mode
is a random linear map from a low-dimensional smooth latent process
(sinusoids + AR(1) drift) to the D observed features.  Sensor-level
heterogeneity comes from Dirichlet-distributed mode proportions — alpha
small => strongly non-IID (each sensor sees mostly one mode), alpha large
=> near-IID — exactly the knob used in the paper's Fig. 7 study.

Anomalies injected into test windows (labels returned):
  - spike: additive heavy-tailed burst on a feature subset,
  - drift: slow additive ramp,
  - stuck: a feature subset frozen at a constant.

``covariate_shift`` adds a linear mean ramp across the WHOLE per-sensor
series; ``label_shift`` confines the anomaly segments to the late
``1 - label_shift`` fraction of the test window.

The generator follows ``repro.data.synthetic`` draw for draw in kind, not
in value: every draw comes from one explicit ``torch.Generator`` (the
Dirichlet mixing weights from a ``numpy.random.Generator`` seeded from
it, since PyTorch has no generator-aware Dirichlet), so the data differ
from ``jax.random``'s and are held to the same properties instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as _device


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    n_sensors: int = 100
    feature_dim: int = 32          # D (paper Table II)
    latent_dim: int = 4
    n_modes: int = 5
    train_len: int = 256           # normal-only training window per sensor
    val_len: int = 64              # normal-only calibration window
    test_len: int = 128            # mixed test window
    dirichlet_alpha: float = 1.0   # mode heterogeneity across sensors
    anomaly_rate: float = 0.15     # fraction of anomalous test points
    noise_std: float = 0.05
    anomaly_scale: float = 1.5
    covariate_shift: float = 0.0   # mean ramp magnitude over the series
    label_shift: float = 0.0       # in [0, 1): anomalies pushed this late

    def __post_init__(self) -> None:
        if not 0.0 <= self.label_shift < 1.0:
            raise ValueError(
                f"label_shift must be in [0, 1), got {self.label_shift!r}"
            )


class SensorDataset(NamedTuple):
    """Stacked per-sensor splits. Leading axis = sensor."""

    train: torch.Tensor        # (N, train_len, D) normal
    val: torch.Tensor          # (N, val_len, D)   normal
    test: torch.Tensor         # (N, test_len, D)  mixed
    test_label: torch.Tensor   # (N, test_len) bool
    n_samples: torch.Tensor    # (N,) f32 — n_i weights for aggregation


def _uniform(g: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=g)


def _latent_process(g: torch.Generator, n: int, length: int, dim: int) -> torch.Tensor:
    """(n, length, dim) smooth latents: sinusoids + AR(1) noise."""
    t = torch.arange(length, dtype=torch.float32)[None, :, None]
    freq = _uniform(g, (n, 1, dim), 0.01, 0.1)
    phase = _uniform(g, (n, 1, dim), 0.0, 2.0 * math.pi)
    sin = torch.sin(2.0 * math.pi * freq * t + phase)
    noise = torch.randn((n, length, dim), generator=g) * 0.3
    ar = torch.empty_like(noise)
    carry = torch.zeros((n, dim))
    for s in range(length):
        carry = 0.9 * carry + noise[:, s]
        ar[:, s] = carry
    return sin + 0.2 * ar


def _inject_anomalies(
    g: torch.Generator, x: torch.Tensor, rate: float, scale: float,
    label_shift: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Inject ~3 anomaly segments per sensor; returns (x', labels).
    ``x`` is (n, length, d)."""
    n, length, d = x.shape
    n_seg = 3
    seg_len = max(1, int(rate * length / n_seg))
    min_start = int(label_shift * max(1, length - seg_len))
    starts = torch.randint(
        min_start, max(min_start + 1, length - seg_len), (n, n_seg), generator=g
    )
    pos = torch.arange(length)[None, None, :]
    label = ((pos >= starts[..., None]) & (pos < starts[..., None] + seg_len)).any(1)

    feat_mask = (torch.rand((n, 1, d), generator=g) < 0.4).to(x.dtype)
    kind = torch.randint(0, 3, (n, 1, 1), generator=g)
    mag = scale * (1.0 + torch.rand((n, 1, 1), generator=g))
    spike = x + mag * feat_mask * torch.sign(torch.randn(x.shape, generator=g))
    ramp = x + mag * feat_mask * torch.linspace(0.0, 1.0, length)[None, :, None]
    stuck = torch.where(feat_mask > 0, x.mean(1, keepdim=True) + mag, x)
    anom = torch.where(kind == 0, spike, torch.where(kind == 1, ramp, stuck))
    return torch.where(label[..., None], anom, x), label


def generate(
    generator: torch.Generator, cfg: SyntheticConfig,
    *, device: torch.device | str | None = None,
) -> SensorDataset:
    """Generate the full stacked dataset for all sensors (drawn on the
    CPU, returned on ``device``)."""
    dev = _device.resolve(device)
    g = generator
    n, dim = cfg.n_sensors, cfg.feature_dim
    mode_maps = torch.randn((cfg.n_modes, cfg.latent_dim, dim), generator=g) / math.sqrt(
        cfg.latent_dim
    )
    seed = int(torch.randint(0, 2**62, (1,), generator=g))
    mix = torch.from_numpy(
        np.random.default_rng(seed).dirichlet(np.full(cfg.n_modes, cfg.dirichlet_alpha), n)
    ).to(torch.float32)                                              # (N, n_modes)

    total = cfg.train_len + cfg.val_len + cfg.test_len
    latent = _latent_process(g, n, total, cfg.latent_dim)
    obs_map = torch.einsum("nm,mld->nld", mix, mode_maps)            # (N, latent, D)
    x = latent @ obs_map + cfg.noise_std * torch.randn((n, total, dim), generator=g)
    if cfg.covariate_shift:
        x = x + cfg.covariate_shift * torch.linspace(0.0, 1.0, total)[None, :, None]
    train = x[:, : cfg.train_len]
    val = x[:, cfg.train_len : cfg.train_len + cfg.val_len]
    test, label = _inject_anomalies(
        g, x[:, cfg.train_len + cfg.val_len :], cfg.anomaly_rate,
        cfg.anomaly_scale, cfg.label_shift,
    )
    return SensorDataset(
        train=train.contiguous().to(dev),
        val=val.contiguous().to(dev),
        test=test.contiguous().to(dev),
        test_label=label.to(dev),
        n_samples=torch.full((n,), float(cfg.train_len), device=dev),
    )


def normalize(ds: SensorDataset) -> SensorDataset:
    """Per-sensor z-score using train statistics (standard AD protocol)."""
    mean = torch.mean(ds.train, dim=1, keepdim=True)
    std = torch.std(ds.train, dim=1, keepdim=True, unbiased=False) + 1e-6
    return SensorDataset(
        train=(ds.train - mean) / std,
        val=(ds.val - mean) / std,
        test=(ds.test - mean) / std,
        test_label=ds.test_label,
        n_samples=ds.n_samples,
    )

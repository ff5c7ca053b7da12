"""Real anomaly-detection benchmarks: SMD, SMAP, MSL (paper Sec. VI-F).

Each loader first looks for the real files under ``data_dir`` (the
standard OmniAnomaly / Telemanom npy layout: ``<name>/<channel>_train.npy``,
``_test.npy``, ``_labels.npy``).  When they are absent it falls back to a
statistically matched surrogate: the published entity count, feature
dimension and test anomaly base rate, generated from the synthetic IoUT
process (``data/synthetic``) with a ``torch.Generator`` seeded by
``seed``.  ``BenchmarkData.source`` says which was used.

Published shapes reproduced:
  SMD : 10 machines  x D=38  (the paper's subset)
  SMAP: 55 channels  x D=25
  MSL : 27 channels  x D=55
"""
from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.data.synthetic import SensorDataset, SyntheticConfig, generate, normalize


@dataclasses.dataclass(frozen=True)
class BenchmarkSpec:
    name: str
    n_entities: int
    feature_dim: int
    anomaly_rate: float   # published approximate test anomaly base rate


SPECS = {
    "smd": BenchmarkSpec("smd", 10, 38, 0.042),
    "smap": BenchmarkSpec("smap", 55, 25, 0.13),
    "msl": BenchmarkSpec("msl", 27, 55, 0.105),
}


class BenchmarkData(NamedTuple):
    dataset: SensorDataset
    source: str  # "real" | "surrogate"


def _try_load_real(
    spec: BenchmarkSpec, data_dir: str, max_len: int, device: torch.device,
) -> SensorDataset | None:
    """The first ``n_entities`` entities found under ``data_dir/<name>``
    (sorted by name), each cut to ``max_len`` rows; the last fifth of each
    train series is its validation split, and every split is cut to its
    shortest entity.  None without files."""
    root = os.path.join(data_dir, spec.name)
    if not os.path.isdir(root):
        return None
    entities = sorted(f[: -len("_train.npy")] for f in os.listdir(root)
                      if f.endswith("_train.npy"))
    if not entities:
        return None
    trains, vals, tests, labels = [], [], [], []
    for e in entities[: spec.n_entities]:
        tr = np.load(os.path.join(root, f"{e}_train.npy"))[:max_len]
        te = np.load(os.path.join(root, f"{e}_test.npy"))[:max_len]
        lb = np.load(os.path.join(root, f"{e}_labels.npy"))[:max_len]
        n_val = max(1, len(tr) // 5)
        trains.append(tr[:-n_val])
        vals.append(tr[-n_val:])
        tests.append(te)
        labels.append(lb.astype(bool))

    def stack(parts):
        m = min(p.shape[0] for p in parts)
        return torch.from_numpy(np.stack([p[:m] for p in parts]).astype(np.float32)).to(device)

    train, val, test = stack(trains), stack(vals), stack(tests)
    label = torch.from_numpy(np.stack([lab[: test.shape[1]] for lab in labels])).to(device)
    n = torch.full((train.shape[0],), float(train.shape[1]), device=device)
    return SensorDataset(train, val, test, label, n)


def _surrogate(spec: BenchmarkSpec, seed: int, length: int,
               device: torch.device) -> SensorDataset:
    cfg = SyntheticConfig(
        n_sensors=spec.n_entities,
        feature_dim=spec.feature_dim,
        train_len=length,
        val_len=max(32, length // 4),
        test_len=length,
        dirichlet_alpha=0.5,       # benchmark entities are heterogeneous
        anomaly_rate=spec.anomaly_rate,
        n_modes=max(4, spec.n_entities // 8),
    )
    return generate(torch.Generator().manual_seed(seed), cfg, device=device)


def load(
    name: str,
    data_dir: str = "data",
    seed: int = 0,
    length: int = 512,
    device: torch.device | str | None = None,
) -> BenchmarkData:
    """Load a benchmark by name on ``device`` (None = the card), the real
    files if present (each series cut to ``4 * length`` rows), the
    surrogate otherwise; both normalised per entity."""
    spec = SPECS[name.lower()]
    dev = _device.resolve(device)
    real = _try_load_real(spec, data_dir, 4 * length, dev)
    if real is not None:
        return BenchmarkData(dataset=normalize(real), source="real")
    return BenchmarkData(dataset=normalize(_surrogate(spec, seed, length, dev)),
                         source="surrogate")

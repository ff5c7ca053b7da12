"""Client data partitioning, including Dirichlet non-IID splits (Fig. 7).

The synthetic generator already supports mode-level Dirichlet
heterogeneity directly; this module adds the classical *pooled-data*
partitioner used for the real benchmarks (split one entity's series
across several virtual sensors) and utilities for mapping entities onto
the deployment.  Random draws take a ``torch.Generator`` (the Dirichlet
rows through numpy seeded from it, as ``data/synthetic.generate`` draws
its mode mixtures).
"""
from __future__ import annotations

import numpy as np
import torch


def dirichlet_proportions(
    generator: torch.Generator, n_clients: int, n_groups: int, alpha: float
) -> torch.Tensor:
    """(n_clients, n_groups) f32 Dirichlet(alpha) rows."""
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    rows = np.random.default_rng(seed).dirichlet(np.full(n_groups, alpha), n_clients)
    return torch.from_numpy(rows).to(torch.float32)


def contiguous_split(x: torch.Tensor, n_clients: int) -> torch.Tensor:
    """Split a (T, D) series into (n_clients, T // n_clients, D) shards.

    Contiguous (not interleaved) so each client sees a coherent window —
    the realistic federated split for time series.
    """
    per = x.shape[0] // n_clients
    return x[: per * n_clients].reshape(n_clients, per, *x.shape[1:])


def entities_to_sensors(
    generator: torch.Generator, n_entities: int, n_sensors: int
) -> torch.Tensor:
    """Assign each sensor one source entity (round-robin + shuffle)."""
    base = torch.arange(n_sensors) % n_entities
    return base[torch.randperm(n_sensors, generator=generator)]


def replicate_entities(data: torch.Tensor, assignment: torch.Tensor) -> torch.Tensor:
    """Gather per-entity arrays (E, ...) into per-sensor arrays (N, ...)."""
    return data[assignment.long()]

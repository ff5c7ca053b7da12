"""Minibatch index tables for local training.

Local SGD runs E epochs over a client's window; an epoch is a random
permutation of the window's rows cut to whole minibatches (a ragged tail
is dropped).  The fused local-train operator takes the table and indexes
the window per step, so the dense (E * n//bs, bs, D) batch stream never
exists.
"""
from __future__ import annotations

import torch


def multi_epoch_indices(
    generator: torch.Generator, clients: int, n: int, batch_size: int, epochs: int,
) -> torch.Tensor:
    """(clients, epochs * n//bs, bs) int32 row indices into each client's
    n-row window.

    Each epoch's permutation of [0, n) is the argsort of ``n`` f64 uniforms
    drawn from ``generator`` (one ``rand((clients, epochs, n))`` call), then
    truncated to whole minibatches.  Drawn on the generator's device.
    """
    nb = n // batch_size
    keys = torch.rand((clients, epochs, n), generator=generator, dtype=torch.float64)
    perms = torch.argsort(keys, dim=-1)[..., : nb * batch_size]
    return perms.reshape(clients, epochs * nb, batch_size).to(torch.int32)

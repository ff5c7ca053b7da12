"""Minibatch index tables for local training, and token windows for the
language models.

Local SGD runs E epochs over a client's window; an epoch is a random
permutation of the window's rows cut to whole minibatches (a ragged tail
is dropped).  The fused local-train operator takes the table and indexes
the window per step, so the dense (E * n//bs, bs, D) batch stream never
exists on the round path; :func:`epoch_batches` and
:func:`multi_epoch_batches` gather it for callers that want the batches.
"""
from __future__ import annotations

import torch


def epoch_batches(
    generator: torch.Generator | None, data: torch.Tensor, batch_size: int,
    perm: torch.Tensor | None = None,
) -> torch.Tensor:
    """One client's (n, D) window shuffled into (n//bs, bs, D) batches.
    The permutation of [0, n) is ``perm`` when given (the reference's
    draw, say), else the argsort of ``n`` f64 uniforms from
    ``generator``; either is truncated to whole minibatches."""
    n = data.shape[0]
    nb = n // batch_size
    if perm is None:
        perm = torch.argsort(torch.rand((n,), generator=generator, dtype=torch.float64))
    perm = perm.to(device=data.device, dtype=torch.long)[: nb * batch_size]
    return data[perm].reshape(nb, batch_size, *data.shape[1:])


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


def multi_epoch_batches(
    generator: torch.Generator | None, data: torch.Tensor, batch_size: int, epochs: int,
    idx: torch.Tensor | None = None,
) -> torch.Tensor:
    """(epochs * n//bs, bs, D) batch stream for E local epochs of one
    client's (n, D) window: the rows of ``idx`` (an (epochs * n//bs, bs)
    index table, the reference's ``multi_epoch_indices`` say), else of one
    client's :func:`multi_epoch_indices` from ``generator``."""
    if idx is None:
        idx = multi_epoch_indices(generator, 1, data.shape[0], batch_size, epochs)[0]
    return data[idx.to(device=data.device, dtype=torch.long)]


def lm_batches(
    generator: torch.Generator, tokens: torch.Tensor, batch: int, seq_len: int,
) -> torch.Tensor:
    """(batch, seq_len + 1) windows of a token stream at uniform starts in
    [0, max(len - seq_len - 1, 1)) (the federated-LLM example's client
    batches); the starts are drawn on the generator's device, the windows
    gathered on the stream's."""
    n = tokens.shape[0] - seq_len - 1
    starts = torch.randint(0, max(n, 1), (batch,), generator=generator,
                           device=generator.device).to(tokens.device)
    idx = starts[:, None] + torch.arange(seq_len + 1, device=tokens.device)[None, :]
    return tokens[idx]

"""The client phase of a federated round (Eq. 12).

:func:`make_client_solver` returns a BATCHED solver (all clients at once)
that runs the whole E-epoch local SGD phase of the paper autoencoder as
one fused operator, ``kernels/ops.local_train`` (the ``local_train_f32``
kernel on the card, ``kernels/ref.local_train_ref`` on the CPU).  The
reference's legacy per-client scan, which ``LocalTrainConfig(fused=False)``
and models other than the autoencoder select, is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

Params = Any
LossFn = Callable[[Params, torch.Tensor], torch.Tensor]

UNPORTED_SCAN = (
    "the per-client local-SGD scan (LocalTrainConfig(fused=False), or a model "
    "other than the paper autoencoder) is not ported yet (ROADMAP.md queue 1 item 5)"
)


@dataclasses.dataclass(frozen=True)
class LocalTrainConfig:
    """How the round loops run the client phase.  ``fused=True`` is the
    fused local-train operator; ``fused=False`` raises (not ported)."""

    fused: bool = True


def fusable_params(params: Any) -> bool:
    """True when ``params`` is the AE-style MLP the fused kernel handles:
    a list/tuple of ``{"w", "b"}`` layers with chained 2-D weights and an
    output dimension equal to the input dimension (reconstruction)."""
    if not isinstance(params, (list, tuple)) or not params:
        return False
    prev = None
    for layer in params:
        if not isinstance(layer, dict) or set(layer) != {"w", "b"}:
            return False
        w, b = layer["w"], layer["b"]
        if getattr(w, "ndim", 0) != 2 or getattr(b, "ndim", 0) != 1:
            return False
        if b.shape[0] != w.shape[1]:
            return False
        if prev is not None and w.shape[0] != prev:
            return False
        prev = w.shape[1]
    return params[0]["w"].shape[0] == params[-1]["w"].shape[1]


def make_client_solver(
    loss_fn: LossFn,
    *,
    batch_size: int,
    epochs: int,
    lr: float,
    prox_mu: float = 0.0,
    solver: LocalTrainConfig = LocalTrainConfig(),
) -> Callable[[Params, torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]:
    """Build ``clients_fn(params, data (N, window, D), idx (N, steps, bs))
    -> (flat deltas (N, d), mean losses (N,))``.  ``idx`` is the minibatch
    index table of ``data/pipeline.multi_epoch_indices`` (steps = epochs *
    window // batch_size); the deltas are in the ravel order, ready for
    the fused compress-and-aggregate operator."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models import autoencoder as ae

    if not solver.fused or loss_fn is not ae.loss:
        raise NotImplementedError(UNPORTED_SCAN)

    def clients_fn(params, data, idx):
        if not fusable_params(params):
            raise NotImplementedError(UNPORTED_SCAN)
        steps = epochs * (data.shape[1] // batch_size)
        if tuple(idx.shape) != (data.shape[0], steps, batch_size):
            raise ValueError(
                f"index table {tuple(idx.shape)} does not match {data.shape[0]} clients, "
                f"{steps} steps of {batch_size} rows"
            )
        return kops.local_train(params, data, idx, lr, prox_mu)

    return clients_fn

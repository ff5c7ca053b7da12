"""SCAFFOLD control variates (Karimireddy et al., ICML'20), option II.

The paper reports SCAFFOLD unstable under its severe heterogeneity and
keeps it out of the headline tables; the reference implements it so the
released traces can include it, and so does the port.  The control
variates are flat vectors in the parameters' ravel order
(``optim/sgd.ravel_tree``): the server's c (d,) and the clients' c_i
(N, d).  :func:`scaffold_local` is one client's update over a batch
stream (the reference's API); :func:`scaffold_clients` is every client's
at once over the round's index tables, which ``core/flat_fl.train_scaffold``
runs.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.optim.sgd import clients_sgd, ravel_tree, unravel_tree

Params = Any


class ScaffoldState(NamedTuple):
    c_global: torch.Tensor   # (d,) server control variate
    c_local: torch.Tensor    # (N, d) per-client control variates


def init_state(params: Params, n_clients: int) -> ScaffoldState:
    flat = ravel_tree(params)
    return ScaffoldState(torch.zeros_like(flat),
                         torch.zeros((n_clients, flat.shape[0]), dtype=flat.dtype,
                                     device=flat.device))


def scaffold_local(
    loss_fn: Callable[[Params, torch.Tensor], torch.Tensor],
    params: Params,
    batches: torch.Tensor,     # (K, bs, ...) one client's batch stream
    lr: float,
    c_global: torch.Tensor,    # (d,)
    c_i: torch.Tensor,         # (d,)
) -> tuple[Params, torch.Tensor, torch.Tensor]:
    """Option-II SCAFFOLD local update of one client: (new params, new
    c_i, mean loss).  Local steps use the variance-corrected gradient
    g - c_i + c; the new client control variate is c_i - c + (theta^t -
    theta_i) / (K lr)."""
    data = batches.reshape((1, -1) + tuple(batches.shape[2:]))
    k, bs = batches.shape[:2]
    idx = torch.arange(k * bs, device=batches.device).reshape(1, k, bs)
    theta, new_ci, loss = scaffold_clients(loss_fn, params, data, idx, lr, c_global, c_i[None])
    return unravel_tree(theta[0], params), new_ci[0], loss[0]


def scaffold_clients(
    loss_fn: Callable[[Params, torch.Tensor], torch.Tensor],
    params: Params,
    data: torch.Tensor,        # (N, window, ...) per-client windows
    idx: torch.Tensor,         # (N, K, bs) minibatch row indices
    lr: float,
    c_global: torch.Tensor,    # (d,)
    c_local: torch.Tensor,     # (N, d)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`scaffold_local` for every client at once (one vmapped
    gradient a step, ``optim/sgd.clients_sgd``): (theta (N, d) after the K
    steps, new c_i (N, d), mean step loss (N,))."""
    theta, losses = clients_sgd(loss_fn, params, data, idx, lr,
                                lambda g, _: g - c_local + c_global)
    k_steps = max(idx.shape[1], 1)
    anchor = ravel_tree(params)
    new_ci = c_local - c_global + (anchor - theta) / (k_steps * lr)
    return theta, new_ci, losses

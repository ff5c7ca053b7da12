"""Optimisers for local client training (Eq. 12).

Plain SGD, FedProx's proximal SGD (Li et al., MLSys'20), Adam over a
param tree (:func:`adam`, the reference's, with no caller in either
package's round loops) and the E-epoch local-training drivers used by
the federated rounds and the centralised oracle.  :func:`make_client_solver` returns a BATCHED solver (all clients
at once): for the paper autoencoder trained with its own loss it runs
the whole E-epoch phase as one fused operator, ``kernels/ops.local_train``
(the ``local_train_f32`` kernel on the card, ``kernels/ref.local_train_ref``
on the CPU); ``LocalTrainConfig(fused=False)`` and any other model take
the legacy path, a Python loop over the steps whose every step is one
``torch.func.vmap`` of ``torch.func.grad_and_value(loss_fn)`` over the clients (the
reference's vmapped per-client ``lax.scan``), fed by the same injected
minibatch index tables.

Parameter trees are what the reference's are: lists, tuples (NamedTuples
too) and dicts of tensors, with ``None`` for an absent leaf, flattened in
``jax.flatten_util.ravel_pytree``'s order (dict keys sorted), so the flat
deltas index the round's (N, d) buffers the same way in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, NamedTuple

import torch

Params = Any
LossFn = Callable[[Params, torch.Tensor], torch.Tensor]


def _leaves(tree: Params) -> Iterator[torch.Tensor]:
    if tree is None:       # an absent leaf (a language model's untied unembed, ...)
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def _rebuild(tree: Params, leaves: Iterator[torch.Tensor]) -> Params:
    if tree is None:
        return None
    if isinstance(tree, dict):
        built = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: built[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        parts = [_rebuild(x, leaves) for x in tree]
        if isinstance(tree, list):
            return parts
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return next(leaves)


def tree_leaves(tree: Params) -> list[torch.Tensor]:
    """The tensor leaves of ``tree`` in ravel order (``None`` skipped)."""
    return list(_leaves(tree))


def tree_unflatten(like: Params, leaves: Any) -> Params:
    """``like``'s structure over ``leaves`` (in :func:`tree_leaves` order)."""
    return _rebuild(like, iter(leaves))


def ravel_tree(tree: Params) -> torch.Tensor:
    """The leaves of ``tree`` as one flat vector, in ``ravel_pytree``'s
    order (for the autoencoder: ``models/autoencoder.ravel``)."""
    return torch.cat([leaf.reshape(-1) for leaf in _leaves(tree)])


def unravel_tree(flat: torch.Tensor, like: Params) -> Params:
    """Inverse of :func:`ravel_tree`: pieces of ``flat`` shaped as the
    leaves of ``like`` (works inside ``torch.func`` transforms)."""
    pieces, off = [], 0
    for leaf in _leaves(like):
        pieces.append(flat[off: off + leaf.numel()].reshape(leaf.shape))
        off += leaf.numel()
    if off != flat.shape[-1]:
        raise ValueError(f"flat vector has {flat.shape[-1]} entries, the tree {off}")
    return _rebuild(like, iter(pieces))


def _map(fn: Callable[..., torch.Tensor], *trees: Params) -> Params:
    return _rebuild(trees[0], iter(fn(*xs) for xs in zip(*(list(_leaves(t)) for t in trees))))


def sgd(params: Params, grads: Params, lr: float) -> Params:
    return _map(lambda p, g: p - lr * g, params, grads)


def proximal_grad(params: Params, anchor: Params, grads: Params, mu: float) -> Params:
    """grad + mu (theta - theta_anchor): the FedProx proximal term."""
    return _map(lambda g, p, a: g + mu * (p - a), grads, params, anchor)


def grad_and_value(loss_fn: LossFn, data: Any = None) -> Callable[[Params, Any], tuple]:
    """``torch.func.grad_and_value(loss_fn)`` by ``torch.autograd.grad``
    over detached copies of the leaves, so it also takes losses that
    ``torch.func`` refuses: those running non-reentrant checkpointing
    (saved-tensor hooks), as a language model's does.  The given params
    are not marked.

    ``data``, a ``launch/sharding.ClientMesh`` whose ranks each hold an
    equal share of the batch, makes the result the whole batch's: every
    gradient leaf and the loss are mean-reduced over the group in f32
    (``ClientMesh.mean_``), one leaf at a time.  A leaf that is not f32
    then comes back as an f32 copy."""
    def run(params, batch):
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
            loss = loss_fn(_rebuild(params, iter(leaves)), batch)
            grads = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        if data is not None:
            grads = [data.mean_(g) for g in grads]
            loss = data.mean_(loss.clone())
        return _rebuild(params, iter(grads)), loss

    return run


def local_sgd(
    loss_fn: LossFn,
    params: Params,
    batches: Any,
    lr: float,
    data: Any = None,
) -> tuple[Params, torch.Tensor]:
    """Run SGD over a batch stream (a (nb, bs, ...) tensor, or any
    sequence of batches such as a list of token dicts); returns (params,
    mean loss).  Gradients by :func:`grad_and_value`: with ``data`` each
    pass's gradient and loss are the mean over the group's shares of the
    batch, so every rank of the group takes the same steps."""
    grad = grad_and_value(loss_fn, data)
    losses = []
    for batch in batches:
        g, loss = grad(params, batch)
        params = sgd(params, g, lr)
        losses.append(loss)
    return params, torch.mean(torch.stack(losses))


def proximal_local_sgd(
    loss_fn: LossFn,
    params: Params,
    batches: torch.Tensor,
    lr: float,
    mu: float,
) -> tuple[Params, torch.Tensor]:
    """FedProx local solver: SGD on F_i(theta) + mu/2 ||theta - theta^t||^2."""
    anchor = params
    grad = torch.func.grad_and_value(loss_fn)
    losses = []
    for batch in batches:
        g, loss = grad(params, batch)
        params = sgd(params, proximal_grad(params, anchor, g, mu), lr)
        losses.append(loss)
    return params, torch.mean(torch.stack(losses))


def clients_sgd(
    loss_fn: LossFn,
    params: Params,
    data: torch.Tensor,        # (N, window, ...) per-client windows
    idx: torch.Tensor,         # (N, steps, bs) minibatch row indices
    lr: float | torch.Tensor,  # a number, or (N, 1) per client
    correct: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
    theta0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Local SGD for every client at once from the shared ``params`` (or
    from each client's own flat start ``theta0`` (N, d), ``params`` then
    giving only the tree's shapes): step s takes client i's rows ``idx[i,
    s]`` of its window, and the per-client gradient of ``loss_fn`` (one
    ``torch.func.vmap`` over the clients), optionally corrected by
    ``correct(g, theta)`` on the flat (N, d) gradients and parameters
    (FedProx's proximal term, SCAFFOLD's control variates).  Returns
    (theta (N, d) after the last step, flat in :func:`ravel_tree`'s order,
    mean step loss (N,))."""
    n, steps, _ = idx.shape
    theta = (ravel_tree(params).expand(n, -1) if theta0 is None else theta0).clone()
    step = torch.func.vmap(torch.func.grad_and_value(
        lambda flat, batch: loss_fn(unravel_tree(flat, params), batch)))
    rows = torch.arange(n, device=data.device)[:, None]
    losses = []
    for s in range(steps):
        g, loss = step(theta, data[rows, idx[:, s].long()])
        if correct is not None:
            g = correct(g, theta)
        theta = theta - lr * g
        losses.append(loss)
    return theta, torch.mean(torch.stack(losses, dim=1), dim=1)


@dataclasses.dataclass(frozen=True)
class LocalTrainConfig:
    """How the round loops run the client phase (Eq. 12): ``fused=True``
    routes autoencoder clients through the fused local-train operator;
    ``fused=False`` is the legacy per-client scan (:func:`clients_sgd`),
    the equivalence baseline.  Models the kernel cannot express fall back
    to the scan on their own."""

    fused: bool = True


def fusable_params(params: Any, lead: int = 0) -> bool:
    """True when ``params`` is the AE-style MLP the fused kernel handles:
    a list/tuple of ``{"w", "b"}`` layers with chained 2-D weights and an
    output dimension equal to the input dimension (reconstruction), each
    leaf behind ``lead`` leading (trial) axes."""
    if not isinstance(params, (list, tuple)) or not params:
        return False
    prev = None
    for layer in params:
        if not isinstance(layer, dict) or set(layer) != {"w", "b"}:
            return False
        w, b = layer["w"], layer["b"]
        if getattr(w, "ndim", 0) != 2 + lead or getattr(b, "ndim", 0) != 1 + lead:
            return False
        if b.shape[-1] != w.shape[-1]:
            return False
        if prev is not None and w.shape[-2] != prev:
            return False
        prev = w.shape[-1]
    return params[0]["w"].shape[-2] == params[-1]["w"].shape[-1]


def make_client_solver(
    loss_fn: LossFn,
    *,
    batch_size: int,
    epochs: int,
    lr: float,
    prox_mu: float = 0.0,
    solver: LocalTrainConfig = LocalTrainConfig(),
) -> Callable[..., tuple[torch.Tensor, torch.Tensor]]:
    """Build ``clients_fn(params, data (N, window, D), idx (N, steps, bs),
    stacked=False) -> (flat deltas (N, d), mean losses (N,))``.  ``idx``
    is the minibatch index table of ``data/pipeline.multi_epoch_indices``
    (steps = epochs * window // batch_size); the deltas are in the ravel
    order, ready for the fused compress-and-aggregate operator.  With
    ``stacked`` every leaf of ``params`` leads with a trial axis B and the
    N clients are B runs of N / B, run b starting from trial b's params
    (one launch for all the trials).  The paper autoencoder with
    ``solver.fused`` takes the fused operator; anything else the scan,
    proximal when ``prox_mu != 0``.  The scan also takes ``lr`` and
    ``prox_mu`` as (B,) tensors, run b stepping with trial b's values (the
    fused operator takes them as scalars)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models import autoencoder as ae

    def clients_fn(params, data, idx, stacked=False):
        steps = epochs * (data.shape[1] // batch_size)
        if tuple(idx.shape) != (data.shape[0], steps, batch_size):
            raise ValueError(
                f"index table {tuple(idx.shape)} does not match {data.shape[0]} clients, "
                f"{steps} steps of {batch_size} rows"
            )
        if solver.fused and loss_fn is ae.loss and fusable_params(params, int(stacked)):
            return kops.local_train(params, data, idx, lr, prox_mu)
        if stacked:
            like = _map(lambda t: t[0], params)      # one trial's tree: the shapes
            flat = torch.cat([leaf.reshape(leaf.shape[0], -1) for leaf in _leaves(params)], 1)
            anchor = flat.repeat_interleave(data.shape[0] // flat.shape[0], dim=0)
        else:
            like, anchor = params, ravel_tree(params)
        def rows(x):       # a (B,) knob as a (N, 1) value per client row
            if not isinstance(x, torch.Tensor):
                return x
            return x.to(data.device).repeat_interleave(data.shape[0] // x.numel())[:, None]

        correct, mu = None, rows(prox_mu)
        if isinstance(mu, torch.Tensor) or mu != 0.0:
            def correct(g, theta):
                return g + mu * (theta - anchor)

        theta, losses = clients_sgd(loss_fn, like, data, idx, rows(lr), correct,
                                    anchor if stacked else None)
        return theta - anchor, losses

    return clients_fn


class AdamState(NamedTuple):
    mu: Params
    nu: Params
    count: torch.Tensor       # () int32


def adam_init(params: Params) -> AdamState:
    """Zero first and second moments shaped as ``params``, count 0."""
    leaves = list(_leaves(params))
    dev = leaves[0].device if leaves else None
    return AdamState(_map(torch.zeros_like, params), _map(torch.zeros_like, params),
                     torch.zeros((), dtype=torch.int32, device=dev))


def adam(
    params: Params,
    grads: Params,
    state: AdamState,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> tuple[Params, AdamState]:
    """One Adam step over a param tree, the reference's update in its
    order: the moments, then the bias corrections ``1 / (1 - b**count)``
    in f32, then ``lr * mhat / (sqrt(vhat) + eps)`` (plus ``lr *
    weight_decay * p``) subtracted.  Returns new params and state."""
    count = state.count + 1
    mu = _map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = _map(lambda v, g: b2 * v + (1 - b2) * torch.square(g), state.nu, grads)
    c = count.to(torch.float32)
    mhat_scale = 1.0 / (1.0 - torch.pow(b1, c))
    vhat_scale = 1.0 / (1.0 - torch.pow(b2, c))

    def upd(p, m, v):
        step = lr * (m * mhat_scale) / (torch.sqrt(v * vhat_scale) + eps)
        if weight_decay:
            step = step + lr * weight_decay * p
        return p - step

    return _map(upd, params, mu, nu), AdamState(mu, nu, count)

"""The paper's anomaly-detection autoencoder (Table II: 32-16-8-16-32).

A symmetric fully-connected AE with tanh activations, ~1 352 parameters at
D=32.  Parameters keep the JAX package's tree: a list of
``{"w": (d_in, d_out), "b": (d_out,)}`` tensors, so checkpoints keep their
key paths and the score kernels read the weights in that layout.
:func:`from_numpy` / :func:`to_numpy` carry trees across the two packages
(f32 ``{"w", "b"}`` and int8 ``{"qw", "sw", "b"}`` layers alike), and
:func:`ravel` / :func:`unravel` the flat vector in ``ravel_pytree``'s
order, which indexes the round loop's (N, d) error-feedback buffers.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from repro_torch import device as _device

Params = Any


def init(generator: torch.Generator, feature_dim: int = 32,
         hidden: tuple[int, ...] = (16, 8, 16), *,
         device: torch.device | str | None = None) -> Params:
    """Glorot-initialised MLP autoencoder parameters (drawn on the CPU
    from ``generator``, then moved to ``device``)."""
    dev = _device.resolve(device)
    dims = (feature_dim, *hidden, feature_dim)
    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        scale = math.sqrt(2.0 / (a + b))
        w = scale * torch.randn((a, b), generator=generator, dtype=torch.float32)
        params.append({"w": w.to(dev), "b": torch.zeros((b,), device=dev)})
    return params


def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Forward pass of rows ``x`` (..., R, D); tanh on hidden layers,
    linear output.  Layers with a leading trial axis (w (B, d_in, d_out),
    b (B, d_out)) take x (B, R, D), trial by trial."""
    h = x
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"].unsqueeze(-2)
        if i < len(params) - 1:
            h = torch.tanh(h)
    return h


def loss(params: Params, batch: torch.Tensor) -> torch.Tensor:
    """Mean squared reconstruction error (paper Eq. 9/10)."""
    recon = apply(params, batch)
    return torch.mean(torch.sum(torch.square(batch - recon), dim=-1))


def param_count(feature_dim: int = 32, hidden: tuple[int, ...] = (16, 8, 16)) -> int:
    dims = (feature_dim, *hidden, feature_dim)
    return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))


def ravel(params: Params) -> torch.Tensor:
    """Flat (d,) vector in ``jax.flatten_util.ravel_pytree`` order: per
    layer the bias, then the row-major weight (dict keys sort "b" < "w").
    Error-feedback buffers and the kernels' deltas are indexed this way.
    Layers with leading trial axes give (..., d), one vector per trial."""
    lead = tuple(params[0]["b"].shape[:-1])
    leaves = [t for layer in params for t in (layer["b"], layer["w"])]
    if math.prod(lead) == 1:   # one trial: a 1-D cat, the cheapest on the host
        return torch.cat([t.reshape(-1) for t in leaves]).view(lead + (-1,))
    return torch.cat([t.reshape(lead + (-1,)) for t in leaves], dim=-1)


def unravel(flat: torch.Tensor, like: Params) -> Params:
    """Inverse of :func:`ravel`: views of ``flat`` (..., d) shaped as the
    layers of ``like`` (whose own leading axes are not read), with
    ``flat``'s leading axes."""
    sizes = [(layer["b"].shape[-1], tuple(layer["w"].shape[-2:])) for layer in like]
    total = sum(nb + math.prod(w_shape) for nb, w_shape in sizes)
    if flat.dim() < 1 or flat.shape[-1] != total:
        raise ValueError(f"flat vector has shape {tuple(flat.shape)}, the tree {total} entries")
    lead = tuple(flat.shape[:-1])
    out, off = [], 0
    for nb, w_shape in sizes:
        nw = math.prod(w_shape)
        b = flat[..., off: off + nb]
        w = flat[..., off + nb: off + nb + nw].view(lead + w_shape)
        out.append({"w": w, "b": b})
        off += nb + nw
    return out


def from_numpy(tree: Params, device: torch.device | str | None = None) -> Params:
    """A list of layer dicts of arrays (e.g. JAX params through
    ``np.asarray``) -> the same tree of tensors on ``device``; dtypes kept."""
    dev = _device.resolve(device)
    return [
        {k: torch.from_numpy(np.array(v, copy=True)).to(dev) for k, v in layer.items()}
        for layer in tree
    ]


def to_numpy(tree: Params) -> Params:
    """The inverse of :func:`from_numpy`: host numpy arrays, dtypes kept."""
    return [
        {k: v.detach().cpu().numpy() for k, v in layer.items()} for layer in tree
    ]

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
    """Forward pass; tanh on hidden layers, linear output."""
    h = x
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
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
    Error-feedback buffers and the kernels' deltas are indexed this way."""
    return torch.cat([t.reshape(-1) for layer in params for t in (layer["b"], layer["w"])])


def unravel(flat: torch.Tensor, like: Params) -> Params:
    """Inverse of :func:`ravel`: views of ``flat`` shaped as ``like``."""
    total = sum(layer["b"].numel() + layer["w"].numel() for layer in like)
    if flat.shape != (total,):
        raise ValueError(f"flat vector has shape {tuple(flat.shape)}, the tree {total} entries")
    out, off = [], 0
    for layer in like:
        nb, nw = layer["b"].numel(), layer["w"].numel()
        b = flat[off: off + nb]
        w = flat[off + nb: off + nb + nw].view(layer["w"].shape)
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

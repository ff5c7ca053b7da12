"""Kernel front doors: the device of the input picks the implementation.

A CPU tensor goes to the plain version in ``kernels/ref``; a CUDA tensor
goes to the hand-written kernel (``kernels/fused_score``,
``kernels/local_train``, ``kernels/fused_agg``), which raises on anything
it cannot take; there is no fallback.  Counterparts of the same-named
functions of ``repro.kernels.ops``, without their TPU row and 128-lane
padding: the CUDA kernels take the real widths.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels import fused_agg as _fa
from repro_torch.kernels import fused_score as _fs
from repro_torch.kernels import local_train as _lt
from repro_torch.kernels import ref as _ref
from repro_torch.models import autoencoder as ae

BLOCK_ELEMS = _ref.BLOCK_ELEMS   # compression block of the flat updates


def _tau_rows(tau: Any, x: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(tau, dtype=torch.float32, device=x.device)
    return torch.broadcast_to(t, (x.shape[0],)).contiguous()


def _route(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels run on cpu or cuda, not {x.device}")
    return x.device.type


def block_k(k_frac: float) -> int:
    """Survivors kept per block for a keep fraction (Python's round)."""
    return max(1, int(round(k_frac * BLOCK_ELEMS)))


def compress_aggregate(
    deltas: torch.Tensor,     # (N, d) raw per-client flat updates
    err: torch.Tensor,        # (N, d) error-feedback buffers
    fog_id: torch.Tensor,     # (N,) int32 cluster assignment
    weights: torch.Tensor,    # (N,) f32, zeroed for non-participants
    n_fog: int,
    k_frac: float,
    quantize: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback block Top-K (+ int8) and the weighted per-fog sums in
    one operator.  Returns (fog_sum (n_fog, d) unnormalised — divide by the
    per-fog weight totals for Eq. 13 — and new_err (N, d))."""
    fn = _fa.compress_aggregate_blocks if _route(deltas) == "cuda" else _ref.compress_aggregate_ref
    fog_sum, new_err, _ = fn(deltas, err, fog_id, weights, n_fog, block_k(k_frac), quantize)
    return fog_sum, new_err


def local_train(
    params: Any,              # autoencoder params: list of {"w", "b"} layers
    data: torch.Tensor,       # (N, window, D) per-client windows
    idx: torch.Tensor,        # (N, steps, bsz) int32 minibatch row indices
    lr: float,
    prox_mu: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The client phase of a round for every client in one operator: E
    epochs of minibatch SGD (FedProx when ``prox_mu != 0``).  Returns
    (flat deltas (N, d) f32 in the ravel order, mean losses (N,))."""
    ws = tuple(layer["w"] for layer in params)
    if _route(data) == "cuda":
        dims = (int(ws[0].shape[0]),) + tuple(int(w.shape[1]) for w in ws)
        return _lt.train_clients(data, idx, ae.ravel(params), dims, lr, prox_mu)
    return _ref.local_train_ref(data, idx, ws, tuple(layer["b"] for layer in params), lr, prox_mu)


def fused_score(
    x: torch.Tensor,     # (R, d) telemetry rows
    params: Any,         # autoencoder params: list of {"w", "b"} layers
    tau: Any,            # scalar or (R,) per-row thresholds
) -> tuple[torch.Tensor, torch.Tensor]:
    """AE forward + squared-L2 reconstruction error + threshold compare in
    one pass over the rows.  Returns (err (R,) f32, flags (R,) bool)."""
    ws = tuple(layer["w"] for layer in params)
    bs = tuple(layer["b"] for layer in params)
    tau_rows = _tau_rows(tau, x)
    if _route(x) == "cpu":
        return _ref.fused_score_ref(x, ws, bs, tau_rows)
    return _fs.score_rows(x, tau_rows, ws, bs)


def fused_score_q8(
    x: torch.Tensor,     # (R, d) telemetry rows
    qparams: Any,        # quantized AE params: list of {"qw", "sw", "b"}
    tau: Any,            # scalar or (R,) per-row thresholds
) -> tuple[torch.Tensor, torch.Tensor]:
    """int8-serving-weight sibling of :func:`fused_score`: dequantisation
    happens inside the kernel, so the weight buffers stay int8."""
    qws = tuple(layer["qw"] for layer in qparams)
    sws = tuple(layer["sw"] for layer in qparams)
    bs = tuple(layer["b"] for layer in qparams)
    tau_rows = _tau_rows(tau, x)
    if _route(x) == "cpu":
        return _ref.fused_score_q8_ref(x, qws, sws, bs, tau_rows)
    return _fs.score_rows_q8(x, tau_rows, qws, sws, bs)

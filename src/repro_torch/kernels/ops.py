"""Kernel front doors: the device of the input picks the implementation.

A CPU tensor goes to the plain version in ``kernels/ref``; a CUDA tensor
goes to the hand-written kernel in ``kernels/fused_score`` (which raises
on anything it cannot take; there is no fallback).  Counterparts of
``repro.kernels.ops.fused_score`` / ``fused_score_q8``, without their
TPU row and 128-lane padding: the CUDA kernel takes the real widths.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels import fused_score as _fs
from repro_torch.kernels import ref as _ref


def _tau_rows(tau: Any, x: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(tau, dtype=torch.float32, device=x.device)
    return torch.broadcast_to(t, (x.shape[0],)).contiguous()


def _route(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused score runs on cpu or cuda, not {x.device}")
    return x.device.type


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

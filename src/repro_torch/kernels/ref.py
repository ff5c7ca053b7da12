"""Plain PyTorch versions of the port's kernels.

Each function is the counterpart of the same-named oracle in
``repro.kernels.ref``.  The CPU tests run them against the JAX package,
and ``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch


def fused_score_ref(
    x: torch.Tensor,                  # (R, d) telemetry rows
    ws: tuple[torch.Tensor, ...],     # per-layer weights, (d_in, d_out)
    bs: tuple[torch.Tensor, ...],     # per-layer biases, (d_out,)
    tau: torch.Tensor,                # (R,) per-row thresholds
) -> tuple[torch.Tensor, torch.Tensor]:
    """AE forward (tanh hidden layers, linear output), squared-L2
    reconstruction error (Sec. V-D) and the Eq. 32 threshold compare.

    Returns (err (R,) f32, flag (R,) bool).
    """
    x = x.to(torch.float32)
    h = x
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = h @ w.to(torch.float32) + b.to(torch.float32)
        if i < len(ws) - 1:
            h = torch.tanh(h)
    err = torch.sum(torch.square(x - h), dim=-1)
    return err, err > tau


def fused_score_q8_ref(
    x: torch.Tensor,                  # (R, d) telemetry rows
    qws: tuple[torch.Tensor, ...],    # per-layer int8 weights, (d_in, d_out)
    sws: tuple[torch.Tensor, ...],    # per-layer scales, (1, d_out) f32
    bs: tuple[torch.Tensor, ...],     # per-layer f32 biases, (d_out,)
    tau: torch.Tensor,                # (R,) per-row thresholds
) -> tuple[torch.Tensor, torch.Tensor]:
    """int8-weight variant: per-output-channel dequantisation
    (``w = q * scale``), then exactly :func:`fused_score_ref`."""
    ws = tuple(
        q.to(torch.float32) * s.to(torch.float32).reshape(1, -1)
        for q, s in zip(qws, sws)
    )
    return fused_score_ref(x, ws, bs, tau)

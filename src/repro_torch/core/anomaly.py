"""Anomaly scoring, threshold calibration, and detection metrics.

Implements the paper's Sec. V-D (99th-percentile global threshold on a
normal-only validation window) plus the two metrics used in evaluation:
point-wise F1 (synthetic study) and point-adjusted F1 (real benchmarks),
the standard segment-generous protocol.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


def reconstruction_errors(
    apply_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    params: Any,
    x: torch.Tensor,
) -> torch.Tensor:
    """Squared-L2 reconstruction error per sample (paper Sec. V-D)."""
    recon = apply_fn(params, x)
    return torch.sum(torch.square(x - recon), dim=-1)


def calibrate_threshold(errors: torch.Tensor, percentile: float = 99.0,
                        dim: int | None = None) -> torch.Tensor:
    """Global threshold tau_A = p-th percentile of validation errors (Eq. 32),
    linearly interpolated as ``numpy.percentile``: over all of ``errors``,
    or with ``dim`` along that axis (one threshold per trial)."""
    if dim is None:
        return torch.quantile(errors.reshape(-1), percentile / 100.0)
    return torch.quantile(errors, percentile / 100.0, dim=dim)


def flag_anomalies(errors: torch.Tensor, tau: Any) -> torch.Tensor:
    """Boolean anomaly decisions: e > tau_A."""
    return errors > tau


class F1Result(NamedTuple):
    f1: torch.Tensor
    precision: torch.Tensor
    recall: torch.Tensor


def pointwise_f1(pred: torch.Tensor, label: torch.Tensor, dim: int | None = None) -> F1Result:
    """Point-wise F1 over boolean prediction/label arrays: over all of
    them, or with ``dim`` along that axis (one score per trial)."""
    pred = pred.to(torch.float32)
    label = label.to(torch.float32)
    kw = {} if dim is None else {"dim": dim}
    tp = torch.sum(pred * label, **kw)
    fp = torch.sum(pred * (1.0 - label), **kw)
    fn = torch.sum((1.0 - pred) * label, **kw)
    precision = tp / torch.clamp(tp + fp, min=1e-12)
    recall = tp / torch.clamp(tp + fn, min=1e-12)
    f1 = 2.0 * precision * recall / torch.clamp(precision + recall, min=1e-12)
    return F1Result(f1, precision, recall)


def point_adjust(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Point-adjusted predictions (PA protocol, paper Sec. VI-F).

    If any point inside a contiguous anomalous segment is detected, the
    whole segment is credited.  Segments run along the last axis; leading
    axes are trials.
    """
    label = label.to(torch.bool)
    pred = pred.to(torch.bool)
    # Segment id: cumulative count of rising edges, 0 outside segments.
    prev = torch.cat([label.new_zeros(label.shape[:-1] + (1,)), label[..., :-1]], dim=-1)
    start = label & ~prev
    seg_id = torch.cumsum(start.to(torch.int64), -1) * label.to(torch.int64)
    hit_per_seg = torch.zeros(pred.shape[:-1] + (pred.shape[-1] + 1,), dtype=torch.int64,
                              device=pred.device)
    hit_per_seg.scatter_add_(-1, seg_id, (pred & label).to(torch.int64))
    seg_hit = torch.gather(hit_per_seg, -1, seg_id) > 0
    return torch.where(label, seg_hit, pred)


def point_adjusted_f1(pred: torch.Tensor, label: torch.Tensor,
                      dim: int | None = None) -> F1Result:
    """PA-F1: point-wise F1 on point-adjusted predictions (``dim`` as in
    :func:`pointwise_f1`)."""
    return pointwise_f1(point_adjust(pred, label), label, dim)


def evaluate_detector(
    apply_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    params: Any,
    x_val_normal: torch.Tensor,
    x_test: torch.Tensor,
    y_test: torch.Tensor,
    percentile: float = 99.0,
    point_adjusted: bool = False,
) -> F1Result:
    """Full paper protocol: calibrate on normal-only val, score test, F1.
    Rows (R, D); with leading trial axes (x (B, R, D), params whose layers
    lead with B) each trial has its own threshold and F1."""
    val_err = reconstruction_errors(apply_fn, params, x_val_normal)
    tau = calibrate_threshold(val_err, percentile, dim=-1)
    test_err = reconstruction_errors(apply_fn, params, x_test)
    pred = flag_anomalies(test_err, tau[..., None])
    if point_adjusted:
        return point_adjusted_f1(pred, y_test, dim=-1)
    return pointwise_f1(pred, y_test, dim=-1)

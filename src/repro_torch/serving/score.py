"""Fleet-scale fused anomaly scoring — the serving front-end.

The paper's end product is a detection *service*: fog nodes score sensor
telemetry against the autoencoder threshold (Sec. V-D, Eq. 32) that
federated training keeps fresh.  :func:`score` is that hot path: AE
forward, squared-L2 reconstruction error, and threshold compare run as ONE
fused operator (``kernels/ops.fused_score``: the CUDA kernel for CUDA
tensors, the plain PyTorch version for CPU tensors) over a
``(fleet, window, d)`` telemetry batch.  Scoring runs where the params
live; the dense reconstruction never reaches device memory on the kernel
path.

``fused=False`` keeps the three-step pipeline
(``core/anomaly.reconstruction_errors`` + ``flag_anomalies``) as the
equivalence baseline.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import anomaly
from repro_torch.device import default_device  # noqa: F401  (re-export)
from repro_torch.kernels import ops as kops
from repro_torch.models import autoencoder as ae


class ScoreResult(NamedTuple):
    """Per-sample scoring output; both leaves share ``x.shape[:-1]``."""

    error: Any   # squared-L2 reconstruction error (f32)
    flag: Any    # anomaly decision err > tau (bool)


def _rows(params: Any, key: str, x: Any, tau: Any):
    dev = params[0][key].device
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    lead = x.shape[:-1]
    rows = x.reshape(-1, x.shape[-1]).contiguous()
    tau_rows = torch.broadcast_to(
        torch.as_tensor(tau, dtype=torch.float32, device=dev), lead
    ).reshape(-1).contiguous()
    return lead, rows, tau_rows


def _finish(err: torch.Tensor, flag: torch.Tensor, lead) -> ScoreResult:
    # Non-finite errors (NaN telemetry, poisoned/diverged model) are
    # anomalous by policy: ``NaN > tau`` is False, which would otherwise
    # silently pass the corrupt rows as normal.
    flag = flag | ~torch.isfinite(err)
    return ScoreResult(err.reshape(lead), flag.reshape(lead))


def score(params: Any, x: Any, tau: Any, *, fused: bool = True) -> ScoreResult:
    """Score telemetry ``x`` of shape (..., d) against threshold(s) ``tau``
    on the device of ``params``.

    ``tau`` is a scalar or broadcastable to ``x.shape[:-1]`` (per-row
    thresholds — see :func:`fleet_tau` for the per-fog mapping).  Leading
    axes are flattened into one row axis for the kernel and restored on the
    way out, so (fleet, window, d) batches score as a single sweep.
    """
    lead, rows, tau_rows = _rows(params, "w", x, tau)
    if fused:
        err, flag = kops.fused_score(rows, params, tau_rows)
    else:
        err = anomaly.reconstruction_errors(ae.apply, params, rows)
        flag = anomaly.flag_anomalies(err, tau_rows)
    return _finish(err, flag, lead)


def quantize_params(params: Any) -> Any:
    """Per-layer, per-output-channel symmetric int8 weight quantisation.

    Each layer ``{"w", "b"}`` becomes ``{"qw" int8, "sw" (1, d_out) f32,
    "b" f32}`` with ``w ≈ qw * sw`` (``sw = amax(|w|, axis=0) / 127``,
    round half to even, clipped to ±127; all-zero columns stay zero).
    This is the ``weight_dtype="int8"`` serving representation;
    dequantisation happens inside the fused score kernel (:func:`score_q8`).
    """
    q = []
    for layer in params:
        w = torch.as_tensor(layer["w"], dtype=torch.float32)
        scale = torch.amax(torch.abs(w), dim=0, keepdim=True) / 127.0
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        qw = torch.clamp(torch.round(w / safe), -127, 127).to(torch.int8)
        qw = torch.where(scale > 0, qw, torch.zeros_like(qw))
        q.append({
            "qw": qw.contiguous(),
            "sw": scale.contiguous(),
            "b": torch.as_tensor(layer["b"], dtype=torch.float32).contiguous(),
        })
    return q


def dequantize_params(qparams: Any) -> Any:
    """Materialise f32 ``{"w", "b"}`` layers from :func:`quantize_params`
    output (the unfused pipeline and tests use this; the fused path
    dequantises in the kernel instead)."""
    return [
        {"w": layer["qw"].to(torch.float32) * layer["sw"].reshape(1, -1),
         "b": layer["b"]}
        for layer in qparams
    ]


def score_q8(qparams: Any, x: Any, tau: Any, *, fused: bool = True) -> ScoreResult:
    """:func:`score` over int8-quantised serving weights
    (:func:`quantize_params`).  ``fused=False`` materialises f32 weights
    and runs the three-step pipeline — the equivalence baseline."""
    lead, rows, tau_rows = _rows(qparams, "qw", x, tau)
    if fused:
        err, flag = kops.fused_score_q8(rows, qparams, tau_rows)
    else:
        err = anomaly.reconstruction_errors(ae.apply, dequantize_params(qparams), rows)
        flag = anomaly.flag_anomalies(err, tau_rows)
    return _finish(err, flag, lead)


def fleet_tau(
    fog_tau: torch.Tensor,    # (n_fog,) per-fog thresholds
    fog_id: torch.Tensor,     # (fleet,) int fog assignment per sensor
    window: int,
) -> torch.Tensor:
    """Map per-fog thresholds onto a (fleet, window) row-threshold grid."""
    fog_tau = torch.as_tensor(fog_tau, dtype=torch.float32)
    fog_id = torch.as_tensor(fog_id, dtype=torch.int64, device=fog_tau.device)
    return torch.broadcast_to(fog_tau[fog_id][:, None], (fog_id.shape[0], window))


def score_fleet(
    params: Any,
    telemetry: Any,                    # (fleet, window, d)
    *,
    tau: Any = None,
    fog_tau: Any = None,
    fog_id: Any = None,
    **kw: Any,
) -> ScoreResult:
    """Score a fleet batch with either a global or a per-fog threshold.

    Exactly one of ``tau`` (global, Eq. 32) or (``fog_tau``, ``fog_id``)
    must be given; the latter resolves each sensor's rows against its fog
    cluster's streaming threshold (``serving/calibrate``).
    """
    if (tau is None) == (fog_tau is None):
        raise ValueError("pass exactly one of tau or (fog_tau, fog_id)")
    if fog_tau is not None:
        if fog_id is None:
            raise ValueError("fog_tau needs the fog_id sensor assignment")
        tau = fleet_tau(fog_tau, fog_id, telemetry.shape[1])
    return score(params, telemetry, tau, **kw)

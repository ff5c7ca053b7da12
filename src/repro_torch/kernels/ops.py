"""Kernel front doors: the device of the input picks the implementation.

A CPU tensor goes to the plain version in ``kernels/ref``; a CUDA tensor
goes to the hand-written kernel (``kernels/fused_score``,
``kernels/local_train``, ``kernels/fused_agg``, ``kernels/robust_agg``,
``kernels/quant8``, ``kernels/topk_ef``, ``kernels/swa_attention``), which
raises on anything it cannot take; there is no fallback.  Counterparts of the same-named
functions of ``repro.kernels.ops``, without their TPU row and 128-lane
padding: the CUDA kernels take the real widths.  The per-client
compressors (:func:`topk_ef`, :func:`quant8`, :func:`compress`) take a
batch of rows (N, d), where the reference takes one flat vector, and
:func:`swa_decode_attention` a batch of sequences, where the reference
takes one (its caller vmaps it).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.kernels import fused_agg as _fa
from repro_torch.kernels import fused_score as _fs
from repro_torch.kernels import local_train as _lt
from repro_torch.kernels import quant8 as _q8
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import robust_agg as _ra
from repro_torch.kernels import swa_attention as _swa
from repro_torch.kernels import topk_ef as _tk
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


def topk_ef(
    delta: torch.Tensor,      # (N, d) raw per-client flat updates
    err: torch.Tensor,        # (N, d) error-feedback buffers
    k_frac: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise error-feedback Top-K keeping ~``k_frac`` of each
    8192-element block: (sparse (N, d), new_err (N, d))."""
    fn = _tk.topk_ef_blocks if _route(delta) == "cuda" else _ref.blockwise_topk_ef_ref
    return fn(delta, err, block_k(k_frac))


def quant8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Blockwise int8 of (N, d) rows: (q (N, nb, 8192) int8, zeros past d,
    scales (N, nb, 1), d)."""
    fn = _q8.quant8_blocks if _route(x) == "cuda" else _ref.quant8_ref
    q, scale = fn(x)
    return q.reshape(scale.shape + (BLOCK_ELEMS,)), scale[..., None], x.shape[1]


def dequant8(q: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`quant8`: the (N, n) rows."""
    return (q.to(torch.float32) * scale).reshape(q.shape[0], -1)[:, :n]


def compress(
    delta: torch.Tensor,      # (N, d) raw per-client flat updates
    err: torch.Tensor,        # (N, d) error-feedback buffers
    k_frac: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """EF + blockwise Top-K + int8 per client: (recon (N, d), the
    dequantised sparse update the fog decodes, new_err (N, d),
    payload_bits (N,) f32), the Eq. 31 payload of each row, kept
    coordinates times (8 + ceil(log2 d)) bits."""
    fn = _q8.compress_blocks if _route(delta) == "cuda" else _ref.compress_ref
    q, scale, new_err = fn(delta, err, block_k(k_frac))
    d = delta.shape[1]
    block_of = torch.arange(d, device=q.device) // BLOCK_ELEMS
    recon = q.to(torch.float32) * scale[:, block_of]
    b_idx = math.ceil(math.log2(max(d, 2)))
    payload_bits = torch.sum(q != 0, dim=1).to(torch.float32) * (8.0 + b_idx)
    return recon, new_err, payload_bits


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


def wire_k(k_frac: float) -> int:
    """Slots per block of the sparse wire for a keep fraction: at least 1,
    at most a whole block."""
    return min(block_k(k_frac), BLOCK_ELEMS)


def compress_wire(
    deltas: torch.Tensor,     # (N, d) raw per-client flat updates
    err: torch.Tensor,        # (N, d) error-feedback buffers
    k_frac: float,
    quantize: bool = True,
    out: tuple | None = None,  # (idx, q, scale, new_err) buffers to write into
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Emit the sparse wire for a batch of clients: (idx (N, nb, k) int32,
    q (N, nb, k) int8 codes — f32 values without ``quantize`` — scale (N,
    nb) f32, new_err (N, d)), per block k indices, k codes and one scale,
    the Eq. 31 payload as a real object.  With ``out`` the results land in
    those buffers (the kernel writes them directly)."""
    k = wire_k(k_frac)
    if _route(deltas) == "cuda":
        return _fa.compress_wire_blocks(deltas, err, k, quantize, out=out)
    res = _ref.compress_wire_ref(deltas, err, k, quantize)
    if out is None:
        return res
    for buf, r in zip(out, res):
        buf.copy_(r)
    return tuple(out)


def wire_aggregate(
    idx: torch.Tensor,        # (N, nb, k) int32 wire indices
    q: torch.Tensor,          # (N, nb, k) codes
    scale: torch.Tensor,      # (N, nb) f32 per-block scales
    fog_id: torch.Tensor,     # (N,) int32 cluster assignment
    weights: torch.Tensor,    # (N,) f32, zeroed for non-participants
    n_fog: int,
    d: int,
    out: torch.Tensor | None = None,   # (n_fog, d) running fog sums, added to in place
) -> torch.Tensor:
    """Weighted scatter-add of the wire into fog sums: fog_sum (n_fog, d)
    f32, unnormalised; the dense (N, d) reconstructions never exist.  With
    ``out`` the sums are added to it in place and it is returned."""
    if _route(idx) == "cuda":
        return _fa.wire_aggregate_blocks(idx, q, scale, fog_id, weights, n_fog, d, out=out)
    part = _ref.wire_aggregate_ref(idx, q, scale, fog_id, weights, n_fog, d)
    return part if out is None else out.add_(part)


def compress_aggregate_wire(
    deltas: torch.Tensor,     # (N, d) raw per-client flat updates
    err: torch.Tensor,        # (N, d) error-feedback buffers
    fog_id: torch.Tensor,     # (N,) int32 cluster assignment
    weights: torch.Tensor,    # (N,) f32, zeroed for non-participants
    n_fog: int,
    k_frac: float,
    quantize: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sparse-wire twin of :func:`compress_aggregate`: emit the wire, then
    scatter-add it.  (fog_sum (n_fog, d) unnormalised, new_err (N, d)),
    equal to the dense path up to f32 summation order.  No round calls it
    (the chunked round calls :func:`compress_wire` and
    :func:`wire_aggregate` per chunk); it is the counterpart of
    ``repro.kernels.ops.compress_aggregate_wire``, the one-shot wire
    operator that the reference's kernel benchmark times."""
    if _route(deltas) == "cpu":
        return _ref.compress_aggregate_wire_ref(deltas, err, fog_id, weights, n_fog,
                                                wire_k(k_frac), quantize)
    idx, q, scale, new_err = _fa.compress_wire_blocks(deltas, err, wire_k(k_frac), quantize)
    return _fa.wire_aggregate_blocks(idx, q, scale, fog_id, weights, n_fog,
                                     deltas.shape[1]), new_err


def robust_aggregate(
    recon: torch.Tensor,      # (N, d) per-client dequantised reconstructions
    fog_id: torch.Tensor,     # (N,) int32 cluster assignment
    weights: torch.Tensor,    # (N,) f32, zeroed for non-participants
    n_fog: int,
    trim_frac: float,
    mode: str = "trimmed",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Coordinate-wise Byzantine-robust fog aggregation, weighted trimmed
    mean or weighted lower median.  Returns (fog_out (n_fog, d) f32 — the
    NORMALISED robust aggregate, zeros for empty fogs — and fog_weight
    (n_fog,), the Eq. 16 gateway weights).  ``trim_frac`` is clamped to
    [0, 0.4995]; at 0 the trimmed mean is the weighted mean."""
    if mode not in ("trimmed", "median"):
        raise ValueError(f"robust mode must be 'trimmed' or 'median', got {mode!r}")
    beta = min(max(float(trim_frac), 0.0), _ra.MAX_BETA)
    if _route(recon) == "cuda":
        return (_ra.robust_aggregate_blocks(recon, fog_id, weights, n_fog, beta, mode),
                _ref.segment_sum(weights.to(torch.float32), fog_id, n_fog))
    return _ref.robust_aggregate_ref(recon, fog_id, weights, n_fog, beta, mode)


def local_train(
    params: Any,              # autoencoder params: list of {"w", "b"} layers
    data: torch.Tensor,       # (N, window, D) per-client windows
    idx: torch.Tensor,        # (N, steps, bsz) int32 minibatch row indices
    lr: float,
    prox_mu: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The client phase of a round for every client in one operator: E
    epochs of minibatch SGD (FedProx when ``prox_mu != 0``).  Returns
    (flat deltas (N, d) f32 in the ravel order, mean losses (N,)).  Layers
    with a leading trial axis (w (B, d_in, d_out), b (B, d_out)) give each
    of B runs of N / B clients its own start point, as ``jax.vmap`` of the
    reference's local-train step over B trials computes it."""
    ws = tuple(layer["w"] for layer in params)
    if _route(data) == "cuda":
        dims = (int(ws[0].shape[-2]),) + tuple(int(w.shape[-1]) for w in ws)
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


def swa_decode_attention(
    q: torch.Tensor,          # (B, Hq, d) one query token per sequence
    k_cache: torch.Tensor,    # (B, S, Hkv, d)
    v_cache: torch.Tensor,    # (B, S, Hkv, d)
    cache_len: torch.Tensor,  # (B,) int32 valid entries per sequence
    window: int,
) -> torch.Tensor:
    """Single-token sliding-window GQA attention over the last ``window``
    positions of each sequence's cache: (B, Hq, d) in q's dtype, zeros for
    a sequence whose window is empty."""
    if _route(q) == "cuda":
        return _swa.swa_decode(q, k_cache, v_cache, cache_len, window)
    return _ref.sliding_window_decode_attention_ref(q, k_cache, v_cache, cache_len, window)

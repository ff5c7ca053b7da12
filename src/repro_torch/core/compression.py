"""Update compression (paper Sec. V-C) on flat client updates.

Two modes:

- ``blockwise`` (the default here): per 8192-element block, error-feedback
  Top-K by threshold bisection and an int8 round trip.  With ``fused``
  (the default) it runs fused with the fog aggregation in
  ``core/aggregation`` (the ``fused_agg`` kernel on the card); unfused,
  and for quantise-only uploads (``rho_s = 1``, int8), it runs per client
  through :func:`compress_update` (the ``compress_q8`` kernel, or
  ``topk_ef`` with ``quant_bits=32``).  This is the compressor
  ``repro.engine.Engine.resolve_compressor`` gives the round loops on
  every backend; the port has no Engine yet, so it is the port's default.
- ``global``: exact Top-K over the whole flat update, the paper's
  semantics for the ~1,352-parameter autoencoder (rho_s = 0.05 -> K ~ 68),
  in plain PyTorch (``torch.topk``).

Both apply error feedback (Eq. 30) and report the acoustic payload in bits
(Eq. 31): L_u = K (b_q + b_idx).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ops import BLOCK_ELEMS


@dataclasses.dataclass(frozen=True)
class CompressorConfig:
    """Compression knobs.  ``fused=False`` compresses each client on its
    own (:func:`compress_update`) before a dense fog sum: the legacy
    two-pass pipeline, kept as the fused path's equivalence baseline.

    In a config sweep (``Engine.sweep``) a ``global`` compressor's
    ``rho_s`` may be a tensor of per-trial (or, inside the round, per-row)
    values; ``sparse`` then pins the ``rho_s < 1`` predicate, as the
    reference's static aux does (None: derive it from ``rho_s``).  The
    blockwise kernels take ``rho_s`` as a scalar, so there it stays a
    number."""

    rho_s: float | torch.Tensor = 0.05   # sparsification ratio (1.0 = dense)
    quant_bits: int = 8          # post-sparsification bit-width (32 = none)
    mode: str = "blockwise"      # "blockwise" | "global"
    fused: bool = True           # fuse compression into fog aggregation
    sparse: bool | None = None   # pinned rho_s < 1 predicate (None = derive)

    def replace(self, **kw: Any) -> "CompressorConfig":
        # A new rho_s re-derives the predicate unless the caller pins it.
        if "rho_s" in kw and "sparse" not in kw:
            kw["sparse"] = None
        return dataclasses.replace(self, **kw)

    @property
    def is_sparse(self) -> bool:
        if self.sparse is not None:
            return self.sparse
        if isinstance(self.rho_s, torch.Tensor):
            return bool(torch.all(self.rho_s < 1.0))
        return self.rho_s < 1.0

    @property
    def enabled(self) -> bool:
        return self.is_sparse or self.quant_bits < 32


def payload_bits(d: int, cfg: CompressorConfig) -> float:
    """Uplink payload size in bits (paper Eq. 31 / Sec. IV-B)."""
    if not cfg.enabled:
        return 32.0 * d
    bits = float(cfg.quant_bits)
    if not cfg.is_sparse:
        return bits * d  # quantise-only: no index overhead
    b_idx = math.ceil(math.log2(max(d, 2)))
    if isinstance(cfg.rho_s, torch.Tensor):
        # Per-trial ratios: the same count in f32, as the reference traces it.
        return torch.clamp_min(torch.round(cfg.rho_s * d), 1.0) * (bits + b_idx)
    k = max(1.0, round(cfg.rho_s * d))
    return k * (bits + b_idx)


def for_rows(cfg: CompressorConfig, start: int, stop: int) -> CompressorConfig:
    """``cfg`` for rows [start, stop) of a batch whose ``rho_s`` is a
    tensor with a value per row; a number stays as it is."""
    if not isinstance(cfg.rho_s, torch.Tensor):
        return cfg
    return cfg.replace(rho_s=cfg.rho_s[start:stop], sparse=cfg.is_sparse)


def per_row(cfg: CompressorConfig, rows_per_trial: int) -> CompressorConfig:
    """``cfg`` for B trials' rows folded trial-major, ``rows_per_trial``
    each: a (B,) tensor ``rho_s`` repeated to a value per row."""
    if not isinstance(cfg.rho_s, torch.Tensor):
        return cfg
    return cfg.replace(rho_s=cfg.rho_s.repeat_interleave(rows_per_trial), sparse=cfg.is_sparse)


def blockwise_k_frac(d: int, rho_s: float) -> float:
    """Per-block keep fraction for blockwise mode on a length-``d`` vector.

    rho_s is a fraction of the REAL coordinates; blocks keep a uniform k,
    and the zero-padded tail block can contribute at most its real
    coordinates, so when the uniform k exceeds the tail the full blocks
    absorb the difference.
    """
    nb = max(1, -(-d // BLOCK_ELEMS))
    tail = d - (nb - 1) * BLOCK_ELEMS      # real coords in the last block
    target = max(1, round(rho_s * d))
    k = target / nb
    if nb > 1 and k > tail:
        k = (target - tail) / (nb - 1)
    return min(1.0, k / BLOCK_ELEMS)


def validate_blockwise_bits(quant_bits: int) -> None:
    """Blockwise compression is int8-only; reject widths it would silently
    mis-quantise (4/16-bit configs must use mode='global')."""
    if quant_bits not in (8,) and quant_bits < 32:
        raise ValueError(
            f"blockwise mode supports quant_bits 8 or >=32, got "
            f"{quant_bits}; use mode='global' for other widths"
        )


def _global_topk_ef(v: torch.Tensor, k: int | torch.Tensor) -> torch.Tensor:
    """Exact Top-K by magnitude over the last axis (ties at the k-th
    magnitude are all kept, as the ``>=`` mask of the reference does).  A
    tensor ``k`` gives each row of (rows, d) its own count: the k-th
    largest magnitude is read out of a full descending sort, the same
    threshold ``topk`` gives."""
    absv = torch.abs(v)
    if isinstance(k, torch.Tensor):
        srt = torch.sort(absv, dim=-1, descending=True).values
        kth = torch.gather(srt, -1, (k.to(torch.int64) - 1)[:, None])
    else:
        kth = torch.topk(absv, k, dim=-1).values[..., -1:]
    return torch.where(absv >= kth, v, 0.0)


def _quantize_global(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric fixed-point quantise/dequantise with one scale per row;
    the scale is amax times f32(1/qmax), as the reference's jitted
    ``amax / qmax`` computes it."""
    if bits >= 32:
        return x
    qmax = float(2 ** (bits - 1) - 1)
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = amax * (1.0 / qmax)
    safe = torch.where(scale > 0, scale, 1.0)
    q = torch.clamp(torch.round(x / safe), -qmax, qmax)
    return torch.where(scale > 0, q * scale, x)


def compress_update(
    delta: torch.Tensor, err: torch.Tensor, cfg: CompressorConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compress flat client updates (..., d) with error feedback.

    Returns (reconstruction the fog decodes, new error buffer), both
    (..., d).  Blockwise mode takes the per-client kernels of
    ``kernels/ops`` (:func:`repro_torch.kernels.ops.compress`, or
    ``topk_ef`` without quantisation), one launch for all the rows.
    """
    if not cfg.enabled:
        return delta, err
    if cfg.mode == "global":
        v = delta + err
        if cfg.is_sparse and isinstance(cfg.rho_s, torch.Tensor):
            rho = cfg.rho_s.to(v.device)
            rho = rho.repeat_interleave(v.shape[0] // rho.numel())   # a value per row
            sparse = _global_topk_ef(v, torch.clamp_min(torch.round(rho * v.shape[-1]), 1.0))
        elif cfg.is_sparse:
            k = max(1, int(round(cfg.rho_s * v.shape[-1])))
            sparse = _global_topk_ef(v, k)
        else:
            sparse = v
        recon = _quantize_global(sparse, cfg.quant_bits)
        return recon, v - recon
    if cfg.mode == "blockwise":
        validate_blockwise_bits(cfg.quant_bits)
        rows = delta.reshape(-1, delta.shape[-1])
        k_frac = blockwise_k_frac(rows.shape[1], cfg.rho_s)
        if cfg.quant_bits < 32:
            recon, new_err, _ = kops.compress(rows, err.reshape(rows.shape), k_frac)
        else:
            recon, new_err = kops.topk_ef(rows, err.reshape(rows.shape), k_frac)
        return recon.reshape(delta.shape), new_err.reshape(delta.shape)
    raise ValueError(f"unknown compression mode: {cfg.mode}")



def init_error(params: Any) -> torch.Tensor:
    """Zero error-feedback buffer of the flattened parameter count (the
    params' ``ravel_pytree`` order and dtype), on their device."""
    from repro_torch.optim.sgd import ravel_tree

    return torch.zeros_like(ravel_tree(params))


def compression_ratio(d: int, cfg: CompressorConfig) -> float:
    """Effective ratio rho vs uncompressed 32-bit transmission (Sec. V-C)."""
    return payload_bits(d, cfg) / (32.0 * d)

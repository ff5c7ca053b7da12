"""Launch wrapper of the fused compress-and-aggregate kernel
(``csrc/fused_agg.cu``).

:func:`compress_aggregate_blocks` takes CUDA tensors only: the (N, d)
client updates and error-feedback buffers, the (N,) fog assignment and
weights.  It checks them, allocates the outputs with ``torch.empty`` and
makes the kernel's two launches on the current stream: ``select`` (the
threshold, the int8 round trip and new_err per client and 8192-element
block) and ``sum`` (the per-fog weighted sums, clients in index order).
Each launch adds one to ``LAUNCHES["fused_agg"]``.  The CPU route is
``kernels/ops``', which sends CPU tensors to
``kernels/ref.compress_aggregate_ref``, the plain version of the same
function (it returns the same three tensors).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.ref import BLOCK_ELEMS   # kBlock in csrc/fused_agg.cu

LAUNCHES = {"fused_agg": 0}

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    LAUNCHES["fused_agg"] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("fused_agg")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_agg_select.argtypes = [vp, vp, i, i, i, i, vp, vp, vp, vp]
        lib.fused_agg_select.restype = i
        lib.fused_agg_sum.argtypes = [vp, vp, vp, vp, i, i, i, i, vp, vp, vp, vp]
        lib.fused_agg_sum.restype = i
        lib.fused_agg_error_string.argtypes = [i]
        lib.fused_agg_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def compress_aggregate_blocks(
    deltas: torch.Tensor,     # (N, d) f32 raw client updates
    err: torch.Tensor,        # (N, d) f32 error-feedback buffers
    fog_id: torch.Tensor,     # (N,) int32 cluster assignment
    weights: torch.Tensor,    # (N,) f32, zeroed for non-participants
    n_fog: int,
    k: int,                   # survivors kept per 8192-element block
    quantize: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch both passes: (fog_sum (n_fog, d) unnormalised, new_err (N, d),
    threshold (N, nb) per client and block)."""
    device = _launch.require_cuda(deltas, "fused compress-aggregate")
    if deltas.dim() != 2:
        raise ValueError(f"deltas must be (N, d), got {tuple(deltas.shape)}")
    n, d = (int(s) for s in deltas.shape)
    if n < 1 or d < 1 or not 1 <= n_fog <= 65535 or k < 1:
        raise ValueError(f"needs N, d, k >= 1 and 1 <= n_fog <= 65535, got N={n}, "
                         f"d={d}, n_fog={n_fog}, k={k}")
    nb = -(-d // BLOCK_ELEMS)
    _launch.check(deltas, "deltas", torch.float32, (n, d), device)
    _launch.check(err, "err", torch.float32, (n, d), device)
    _launch.check(fog_id, "fog_id", torch.int32, (n,), device)
    _launch.check(weights, "weights", torch.float32, (n,), device)
    new_err = torch.empty((n, d), dtype=torch.float32, device=device)
    thr = torch.empty((n, nb), dtype=torch.float32, device=device)
    scale = torch.empty((n, nb), dtype=torch.float32, device=device)
    fog_sum = torch.empty((n_fog, d), dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = _launch.stream(device)
        rc = lib.fused_agg_select(
            deltas.data_ptr(), err.data_ptr(), n, d, int(k), int(quantize),
            new_err.data_ptr(), thr.data_ptr(), scale.data_ptr(), stream,
        )
        _launch.raise_on(rc, "fused_agg select launch", lib.fused_agg_error_string)
        LAUNCHES["fused_agg"] += 1
        rc = lib.fused_agg_sum(
            deltas.data_ptr(), err.data_ptr(), fog_id.data_ptr(), weights.data_ptr(),
            n, d, n_fog, int(quantize), thr.data_ptr(), scale.data_ptr(),
            fog_sum.data_ptr(), stream,
        )
        _launch.raise_on(rc, "fused_agg sum launch", lib.fused_agg_error_string)
        LAUNCHES["fused_agg"] += 1
    return fog_sum, new_err, thr

"""Launch wrapper of the error-feedback block Top-K kernel
(``csrc/topk_ef.cu``), the per-client compressor without quantisation.

:func:`topk_ef_blocks` takes CUDA tensors only: the (N, d) client updates
and error-feedback buffers.  It checks them, allocates sparse and new_err
(N, d) with ``torch.empty``, launches ``topk_ef`` once on the current
stream (a team per client and 8192-element block, sized to the block's
real width: ``teams.compress_plan``) and adds one to
``LAUNCHES["topk_ef"]``.  The CPU route is
``kernels/ops``', which sends CPU tensors to
``kernels/ref.blockwise_topk_ef_ref``, the plain version of the same
function.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.ref import BLOCK_ELEMS
from repro_torch.kernels.teams import compress_plan, sm_count

LAUNCHES = {"topk_ef": 0}

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    LAUNCHES["topk_ef"] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("topk_ef")
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64     # d is 64-bit
        lib.topk_ef.argtypes = [vp, vp, i, i64, i, i, i, i, i, vp, vp, vp]
        lib.topk_ef.restype = i
        lib.topk_ef_error_string.argtypes = [i]
        lib.topk_ef_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def topk_ef_blocks(
    deltas: torch.Tensor,     # (N, d) f32 raw client updates
    err: torch.Tensor,        # (N, d) f32 error-feedback buffers
    k: int,                   # survivors kept per 8192-element block
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``topk_ef``: (sparse (N, d), new_err (N, d)), sparse +
    new_err == deltas + err exactly."""
    device, n, d, _ = _launch.rows(deltas, "top-k", BLOCK_ELEMS)
    if not 1 <= k <= BLOCK_ELEMS:
        raise ValueError(f"needs 1 <= k <= {BLOCK_ELEMS}, got k={k}")
    _launch.check(deltas, "deltas", torch.float32, (n, d), device)
    _launch.check(err, "err", torch.float32, (n, d), device)
    p = compress_plan(n, d, sm_count(device))
    sparse = torch.empty((n, d), dtype=torch.float32, device=device)
    new_err = torch.empty((n, d), dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        rc = lib.topk_ef(deltas.data_ptr(), err.data_ptr(), n, d, int(k), p.n_wide, p.slots,
                         p.teams, p.narrow_grid, sparse.data_ptr(), new_err.data_ptr(),
                         _launch.stream(device))
        _launch.raise_on(rc, "topk_ef launch", lib.topk_ef_error_string)
        LAUNCHES["topk_ef"] += 1
    return sparse, new_err

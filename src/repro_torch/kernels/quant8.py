"""Launch wrappers of the per-client int8 compressor kernels
(``csrc/quant8.cu``).

:func:`compress_blocks` (``compress_q8``, one launch) takes CUDA tensors
only: the (N, d) client updates and error-feedback buffers.  Per client
and 8192-element block a team sized to the block's real width
(``teams.compress_plan``, ``fused_agg``'s layout) selects the survivors by
the bisection shared with ``fused_agg`` and quantises them to int8,
returning q int8 (N, d), the block scales (N, nb) and new_err (N, d).
:func:`quant8_blocks` (``quant8``, one launch) quantises (N, d) rows per
block, one CTA of 512 threads a block: q int8 (N, nb * 8192) in the
blocked layout (zeros past d) and scales (N, nb).  Each wrapper checks its
inputs, allocates the outputs with ``torch.empty``, launches on the
current stream and adds one to its ``LAUNCHES`` entry.
The CPU route is ``kernels/ops``', which sends CPU tensors to
``kernels/ref.compress_ref`` and ``kernels/ref.quant8_ref``, the plain
versions of the same functions (they return the same tensors).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.ref import BLOCK_ELEMS   # kBlock in csrc/block_select.cuh
from repro_torch.kernels.teams import compress_plan, sm_count

LAUNCHES = {"compress_q8": 0, "quant8": 0}

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("quant8")
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64     # d is 64-bit
        lib.compress_q8.argtypes = [vp, vp, i, i64, i, i, i, i, i, vp, vp, vp, vp]
        lib.compress_q8.restype = i
        lib.quant8.argtypes = [vp, i, i64, vp, vp, vp]
        lib.quant8.restype = i
        lib.quant8_error_string.argtypes = [i]
        lib.quant8_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def compress_blocks(
    deltas: torch.Tensor,     # (N, d) f32 raw client updates
    err: torch.Tensor,        # (N, d) f32 error-feedback buffers
    k: int,                   # survivors kept per 8192-element block
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``compress_q8``: (q (N, d) int8, scale (N, nb) f32, new_err
    (N, d) f32), recon = q * scale of the coordinate's block."""
    device, n, d, nb = _launch.rows(deltas, "compress", BLOCK_ELEMS)
    if not 1 <= k <= BLOCK_ELEMS:
        raise ValueError(f"needs 1 <= k <= {BLOCK_ELEMS}, got k={k}")
    _launch.check(deltas, "deltas", torch.float32, (n, d), device)
    _launch.check(err, "err", torch.float32, (n, d), device)
    p = compress_plan(n, d, sm_count(device))
    q = torch.empty((n, d), dtype=torch.int8, device=device)
    scale = torch.empty((n, nb), dtype=torch.float32, device=device)
    new_err = torch.empty((n, d), dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        rc = lib.compress_q8(deltas.data_ptr(), err.data_ptr(), n, d, int(k), p.n_wide, p.slots,
                             p.teams, p.narrow_grid, q.data_ptr(), scale.data_ptr(),
                             new_err.data_ptr(), _launch.stream(device))
        _launch.raise_on(rc, "compress_q8 launch", lib.quant8_error_string)
        LAUNCHES["compress_q8"] += 1
    return q, scale, new_err


def quant8_blocks(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``quant8`` on (N, d) f32 rows: (q (N, nb * 8192) int8, zeros
    past d, scale (N, nb) f32)."""
    device, n, d, nb = _launch.rows(x, "quant8", BLOCK_ELEMS)
    _launch.check(x, "x", torch.float32, (n, d), device)
    q = torch.empty((n, nb * BLOCK_ELEMS), dtype=torch.int8, device=device)
    scale = torch.empty((n, nb), dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        rc = lib.quant8(x.data_ptr(), n, d, q.data_ptr(), scale.data_ptr(),
                        _launch.stream(device))
        _launch.raise_on(rc, "quant8 launch", lib.quant8_error_string)
        LAUNCHES["quant8"] += 1
    return q, scale

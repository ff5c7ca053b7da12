"""Launch wrappers of the fused score kernels (``csrc/fused_score.cu``).

:func:`score_rows` (f32 weights) and :func:`score_rows_q8` (int8 weights
with per-output-channel scales) take CUDA tensors only: they check device,
dtype, shape and contiguity, allocate the outputs with ``torch.empty``,
launch on the current stream and raise when the launch is refused.  The
CPU path is ``kernels/ops``' business, which sends CPU tensors to the
plain versions in ``kernels/ref``.

Unlike the TPU kernel there is no 128-lane padding: the kernel reads the
real widths and masks the ragged row tile itself.  ``LAUNCHES`` counts each
wrapper's launches (plain integers; :func:`reset_launches` zeroes them).

The first launch on a device opts both kernels in to ``SMEM_LIMIT`` bytes
of dynamic shared memory there and reads its SM count; later launches
reuse both, and the tile layout is cached per (widths, rows, SMs).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _launch

MAX_LAYERS = 8             # kMaxLayers in csrc/fused_score.cu
SMEM_LIMIT = 232_448       # dynamic shared memory one sm_90 block may opt in to

LAUNCHES = {"fused_score_f32": 0, "fused_score_q8": 0}

_lib: ctypes.CDLL | None = None
_n_sm: dict[int, int] = {}  # device index -> SM count, once opted in


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("fused_score")
        vp, i, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        tail = [vp, vp, i, i, i, i, vp]   # err, flag, tile, strides, smem, stream
        lib.fused_score_f32.argtypes = [vp, vp, i, i, ip, ptrs, ptrs, *tail]
        lib.fused_score_f32.restype = i
        lib.fused_score_q8.argtypes = [vp, vp, i, i, ip, ptrs, ptrs, ptrs, *tail]
        lib.fused_score_q8.restype = i
        lib.fused_score_init.argtypes = [i]
        lib.fused_score_init.restype = i
        lib.fused_score_error_string.argtypes = [i]
        lib.fused_score_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _library().fused_score_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def _sm_count(device: torch.device) -> int:
    """SM count of ``device``; its first call there opts both kernels in
    to ``SMEM_LIMIT`` bytes of dynamic shared memory."""
    n_sm = _n_sm.get(device.index)
    if n_sm is None:
        with torch.cuda.device(device):
            _raise_on(_library().fused_score_init(SMEM_LIMIT), "fused_score_init")
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        _n_sm[device.index] = n_sm
    return n_sm


@functools.lru_cache(maxsize=256)
def layout(dims: tuple[int, ...], rows: int, n_sm: int) -> tuple[int, int, int, int]:
    """(rows per block, row stride, hidden stride, shared-memory bytes).

    Strides are odd so a warp's 32 row columns fall in 32 banks.  The tile
    shrinks from 128 rows (to at least 32) until the grid has a block for
    each of the ``n_sm`` SMs or the staged weights, row tile and two
    hidden buffers fit."""
    x_stride = dims[0] | 1
    hidden = dims[1:-1]
    h_stride = (max(hidden) | 1) if hidden else 0
    w_floats = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    tile = 128
    while tile > 32 and tile * n_sm > rows:
        tile //= 2
    while True:
        smem = 4 * (w_floats + tile * (x_stride + 2 * h_stride))
        if smem <= SMEM_LIMIT:
            return tile, x_stride, h_stride, smem
        if tile == 32:
            raise ValueError(
                f"autoencoder widths {dims} need {smem} B of shared memory "
                f"per 32-row block; the kernel has {SMEM_LIMIT}"
            )
        tile //= 2


def _check_rows(x: torch.Tensor, tau: torch.Tensor, n_layers: int) -> torch.device:
    _launch.require_cuda(x, "fused score")
    if x.dim() != 2:
        raise ValueError(f"x must be (R, d), got {tuple(x.shape)}")
    if not 1 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"the kernel takes 1..{MAX_LAYERS} layers, got {n_layers}")
    _launch.check(x, "x", torch.float32, tuple(x.shape), x.device)
    _launch.check(tau, "tau", torch.float32, (x.shape[0],), x.device)
    return x.device


def _dims(x: torch.Tensor, ws) -> tuple[int, ...]:
    dims = (int(x.shape[1]),) + tuple(int(w.shape[1]) for w in ws)
    if dims[-1] != dims[0]:
        raise ValueError(f"the autoencoder must output d={dims[0]}, got {dims[-1]}")
    return dims


def _run(fn, name: str, x, tau, dims, weight_ptrs, device):
    rows = int(x.shape[0])
    err = torch.empty((rows,), dtype=torch.float32, device=device)
    flag = torch.empty((rows,), dtype=torch.bool, device=device)
    if rows == 0:
        return err, flag
    tile, x_stride, h_stride, smem = layout(dims, rows, _sm_count(device))
    n_layers = len(dims) - 1
    arrays = [(ctypes.c_void_p * n_layers)(*ptrs) for ptrs in weight_ptrs]
    with torch.cuda.device(device):
        stream = _launch.stream(device)
        rc = fn(
            x.data_ptr(), tau.data_ptr(), rows, n_layers,
            (ctypes.c_int * len(dims))(*dims), *arrays,
            err.data_ptr(), flag.data_ptr(), tile, x_stride, h_stride, smem,
            stream,
        )
    _raise_on(rc, f"{name} launch")
    LAUNCHES[name] += 1
    return err, flag


def score_rows(
    x: torch.Tensor,                  # (R, d) f32, CUDA, contiguous
    tau: torch.Tensor,                # (R,) f32 per-row thresholds
    ws: tuple[torch.Tensor, ...],     # (d_in, d_out) f32 weights
    bs: tuple[torch.Tensor, ...],     # (d_out,) f32 biases
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``fused_score_f32``: (err (R,) f32, flag (R,) bool)."""
    device = _check_rows(x, tau, len(ws))
    dims = _dims(x, ws)
    for i, (w, b) in enumerate(zip(ws, bs, strict=True)):
        _launch.check(w, f"ws[{i}]", torch.float32, (dims[i], dims[i + 1]), device)
        _launch.check(b, f"bs[{i}]", torch.float32, (dims[i + 1],), device)
    lib = _library()
    return _run(
        lib.fused_score_f32, "fused_score_f32", x, tau, dims,
        [[w.data_ptr() for w in ws], [b.data_ptr() for b in bs]], device,
    )


def score_rows_q8(
    x: torch.Tensor,                  # (R, d) f32, CUDA, contiguous
    tau: torch.Tensor,                # (R,) f32 per-row thresholds
    qws: tuple[torch.Tensor, ...],    # (d_in, d_out) int8 weights
    sws: tuple[torch.Tensor, ...],    # (1, d_out) or (d_out,) f32 scales
    bs: tuple[torch.Tensor, ...],     # (d_out,) f32 biases
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``fused_score_q8``: (err (R,) f32, flag (R,) bool)."""
    device = _check_rows(x, tau, len(qws))
    dims = _dims(x, qws)
    for i, (q, s, b) in enumerate(zip(qws, sws, bs, strict=True)):
        _launch.check(q, f"qws[{i}]", torch.int8, (dims[i], dims[i + 1]), device)
        _launch.check(s, f"sws[{i}]", torch.float32, tuple(s.shape), device)
        if s.numel() != dims[i + 1]:
            raise ValueError(f"sws[{i}] has {s.numel()} scales, expected {dims[i + 1]}")
        _launch.check(b, f"bs[{i}]", torch.float32, (dims[i + 1],), device)
    lib = _library()
    return _run(
        lib.fused_score_q8, "fused_score_q8", x, tau, dims,
        [[q.data_ptr() for q in qws], [s.data_ptr() for s in sws],
         [b.data_ptr() for b in bs]], device,
    )

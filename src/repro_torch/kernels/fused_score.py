"""Launch wrappers of the fused score kernels (``csrc/fused_score.cu``).

:func:`score_rows` (f32 weights) and :func:`score_rows_q8` (int8 weights
with per-output-channel scales) take CUDA tensors only: they check device,
dtype, shape and contiguity, allocate the outputs with ``torch.empty``,
launch on the current stream and raise when the launch is refused.  The
CPU path is ``kernels/ops``' business, which sends CPU tensors to the
plain versions in ``kernels/ref``.

Unlike the TPU kernel there is no 128-lane padding: the kernels read the
real widths and mask the ragged rows themselves.  ``LAUNCHES`` counts each
wrapper's launches (plain integers; :func:`reset_launches` zeroes them).

The first launch on a device opts the kernels in to ``SMEM_LIMIT`` bytes
of dynamic shared memory there and reads its SM count; later launches
reuse both.  Both kernels take their instance and grid from :func:`plan`
(a warp per group of ``ROWS_PER_WARP`` rows), cached per (widths, rows,
SMs): int8 weights are dequantised as they are loaded and then run the
f32 kernel's row chain, so a row's err is the f32 kernel's on the
dequantised weights, bit for bit.  Both wrappers build the ctypes pointer
arrays once per weight set, keyed on the tensors' ``data_ptr``s, so a
hot-swapped set gets its own.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, _launch

MAX_LAYERS = 8             # kMaxLayers in csrc/fused_score.cu
SMEM_LIMIT = 232_448       # dynamic shared memory one sm_90 block may opt in to
ROWS_PER_WARP = 4          # kGroupRows: the rows one warp scores together
MAX_WARPS = 8              # kMaxWarps: warps per block, at most
RESIDENT_WARPS = 16        # warps per SM a large batch keeps in flight
PAPER_DIMS = (32, 16, 8, 16, 32)   # PaperAE, the compile-time instance
PAPER_STRIP = ROWS_PER_WARP * (36 + 20 + 8)   # PaperAE::kStrip, floats per warp
ARG_CACHE = 64             # weight sets whose ctypes arrays are kept

LAUNCHES = {"fused_score_f32": 0, "fused_score_q8": 0}

_lib: ctypes.CDLL | None = None
_n_sm: dict[int, int] = {}  # device index -> SM count, once opted in
_args: dict[tuple, tuple] = {}   # (dims, weight, scale and bias ptrs) -> ctypes arrays


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("fused_score")
        vp, i, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        tail = [vp, vp, i, i, i, i, i, i, i, i, vp]   # err, flag, the plan, stream
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
    """SM count of ``device``; its first call there opts the kernels that
    stage weights in to ``SMEM_LIMIT`` bytes of dynamic shared memory."""
    n_sm = _n_sm.get(device.index)
    if n_sm is None:
        with torch.cuda.device(device):
            _raise_on(_library().fused_score_init(SMEM_LIMIT), "fused_score_init")
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        _n_sm[device.index] = n_sm
    return n_sm


class Plan(NamedTuple):
    """A score kernel's launch: the instance, the grid and the shared
    memory of each warp's strip (floats) and of the block (bytes)."""
    paper: bool          # the PaperAE instance (weights in registers)
    warps: int           # warps per block
    blocks: int
    x_stride: int        # strip row stride of x and the differences (Generic)
    h_stride: int        # strip row stride of the hidden activations (Generic)
    strip: int           # floats per warp
    w_floats: int        # weights and biases staged per block (Generic), else 0
    smem: int            # dynamic shared memory per block, bytes (Generic), else 0


def _align4(n: int) -> int:
    return -(-n // 4) * 4


@functools.lru_cache(maxsize=256)
def plan(dims: tuple[int, ...], rows: int, n_sm: int) -> Plan:
    """The launch of either score kernel for ``rows`` rows of widths
    ``dims`` on ``n_sm`` SMs (int8 weights are staged dequantised, as f32).

    A warp scores ``ROWS_PER_WARP`` rows at a time.  Up to
    ``RESIDENT_WARPS`` per SM, there is a warp per group; past that the
    warps walk the groups with a stride.  The paper AE runs the
    compile-time instance (weights in registers, no dynamic shared memory)
    in blocks of as many warps (a power of two up to ``MAX_WARPS``) as keep
    one block per SM or more.  Other widths stage their weights once per
    block, so their blocks keep ``MAX_WARPS`` warps unless that does not fit
    in ``SMEM_LIMIT``.  The instance depends on the widths alone, so a row
    scores the same in every batch."""
    groups = -(-rows // ROWS_PER_WARP)
    warps = max(1, min(groups, n_sm * RESIDENT_WARPS))
    per_block = MAX_WARPS
    if tuple(dims) == PAPER_DIMS:
        while per_block > 1 and -(-warps // per_block) < n_sm:
            per_block //= 2
        return Plan(True, per_block, -(-warps // per_block), 0, 0, PAPER_STRIP, 0, 0)
    x_stride = _align4(dims[0])
    hidden = dims[1:-1]
    h_stride = _align4(max(hidden)) if hidden else 0
    strip = ROWS_PER_WARP * (2 * x_stride + 2 * h_stride)
    w_floats = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    while True:
        smem = 4 * (w_floats + per_block * strip)
        if smem <= SMEM_LIMIT:
            return Plan(False, per_block, -(-warps // per_block), x_stride, h_stride, strip,
                        w_floats, smem)
        if per_block == 1:
            raise ValueError(
                f"autoencoder widths {dims} need {smem} B of shared memory "
                f"per one-warp block; the kernel has {SMEM_LIMIT}"
            )
        per_block //= 2


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


def _arrays(dims: tuple[int, ...], *sets) -> tuple:
    """The ctypes dims array and one pointer array per tensor set (weights,
    scales, biases) of one weight set, built once and kept while its
    tensors stay where they are (the key is their ``data_ptr``s)."""
    key = (dims, *(tuple(t.data_ptr() for t in ts) for ts in sets))
    arrays = _args.get(key)
    if arrays is None:
        n = len(dims) - 1
        arrays = ((ctypes.c_int * len(dims))(*dims),
                  *((ctypes.c_void_p * n)(*ptrs) for ptrs in key[1:]))
        if len(_args) >= ARG_CACHE:
            _args.clear()
        _args[key] = arrays
    return arrays


def _launch_rows(name: str, x, tau, dims, sets, device):
    """Allocate (err, flag), launch ``name`` with the plan for ``dims`` and
    count it; ``sets`` are the weight set's tensor tuples in the C entry's
    order."""
    rows = int(x.shape[0])
    err = torch.empty((rows,), dtype=torch.float32, device=device)
    flag = torch.empty((rows,), dtype=torch.bool, device=device)
    if rows == 0:
        return err, flag
    p = plan(dims, rows, _sm_count(device))
    arrays = _arrays(dims, *sets)
    with torch.cuda.device(device):
        rc = getattr(_library(), name)(
            x.data_ptr(), tau.data_ptr(), rows, len(dims) - 1, *arrays,
            err.data_ptr(), flag.data_ptr(), int(p.paper), p.warps, p.blocks, p.x_stride,
            p.h_stride, p.strip, p.w_floats, p.smem, _launch.stream(device),
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
    if len(bs) != len(ws):
        raise ValueError(f"{len(ws)} weights but {len(bs)} biases")
    for i, (w, b) in enumerate(zip(ws, bs)):
        w_shape, b_shape = (dims[i], dims[i + 1]), (dims[i + 1],)
        if not (w.dtype == b.dtype == torch.float32 and w.device == b.device == device
                and w.shape == w_shape and b.shape == b_shape
                and w.is_contiguous() and b.is_contiguous()):
            _launch.check(w, f"ws[{i}]", torch.float32, w_shape, device)
            _launch.check(b, f"bs[{i}]", torch.float32, b_shape, device)
    return _launch_rows("fused_score_f32", x, tau, dims, (ws, bs), device)


def score_rows_q8(
    x: torch.Tensor,                  # (R, d) f32, CUDA, contiguous
    tau: torch.Tensor,                # (R,) f32 per-row thresholds
    qws: tuple[torch.Tensor, ...],    # (d_in, d_out) int8 weights
    sws: tuple[torch.Tensor, ...],    # (1, d_out) or (d_out,) f32 scales
    bs: tuple[torch.Tensor, ...],     # (d_out,) f32 biases
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``fused_score_q8``: (err (R,) f32, flag (R,) bool), bitwise
    :func:`score_rows` on the weights ``q.to(f32) * s``."""
    device = _check_rows(x, tau, len(qws))
    dims = _dims(x, qws)
    for i, (q, s, b) in enumerate(zip(qws, sws, bs, strict=True)):
        _launch.check(q, f"qws[{i}]", torch.int8, (dims[i], dims[i + 1]), device)
        _launch.check(s, f"sws[{i}]", torch.float32, tuple(s.shape), device)
        if s.numel() != dims[i + 1]:
            raise ValueError(f"sws[{i}] has {s.numel()} scales, expected {dims[i + 1]}")
        _launch.check(b, f"bs[{i}]", torch.float32, (dims[i + 1],), device)
    return _launch_rows("fused_score_q8", x, tau, dims, (qws, sws, bs), device)

"""Launch wrapper of the fused local-train kernel (``csrc/local_train.cu``).

:func:`train_clients` takes CUDA tensors only: the clients' windows, the
minibatch index table, and the broadcast parameters as one flat vector in
the ravel order (``models/autoencoder.ravel``).  It checks them, allocates
the outputs with ``torch.empty``, launches on the current stream (one block
of 8 warps per client) and raises when the launch is refused.  The CPU
route is ``kernels/ops``', which sends CPU tensors to
``kernels/ref.local_train_ref``.  A (B, d) theta gives each of B runs of
N / B clients its own start vector: the batched trial engine folds its
trials into the client axis, one launch for all of them.

``LAUNCHES["local_train_f32"]`` counts launches; :func:`layout` sizes the
shared memory and refuses widths that do not fit.  Design: each warp takes
its rows of the minibatch forward and back alone, then the block updates
every layer at once (two block barriers a step); the next step's rows are
gathered by ``cp.async`` into a second buffer while this step computes.
The paper AE (32-16-8-16-32) runs an instance with compile-time widths,
any other widths the same design with run-time widths.  The launch opts
the kernel in to the block's dynamic shared memory.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _launch

MAX_LAYERS = 8                   # kMaxLayers in csrc/local_train.cu
# Dynamic shared memory one sm_90 block may opt in to (227 KB), less 1 KB
# kept for the kernel's static shared memory.
SMEM_LIMIT = 232_448 - 1_024

LAUNCHES = {"local_train_f32": 0}

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    LAUNCHES["local_train_f32"] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("local_train")
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ip = ctypes.POINTER(ctypes.c_int)
        lib.local_train_f32.argtypes = [
            vp, i, i, vp, i, i, vp, i, i, ip, ip, ip, ip, i, i, f, f, vp, vp, i, vp,
        ]
        lib.local_train_f32.restype = i
        lib.local_train_error_string.argtypes = [i]
        lib.local_train_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _align4(n: int) -> int:
    return -(-n // 4) * 4


def _row_stride(width: int) -> int:
    """Row stride of an activation or gradient buffer: packed where the
    width is below 32 and divides it, 48 for 32 (the update reads
    consecutive rows at once, which then fall in other banks), else
    16-byte rows plus 4 floats."""
    if width == 32:
        return 48
    return width if 32 % width == 0 else _align4(width) + 4


@functools.lru_cache(maxsize=64)
def layout(dims: tuple[int, ...], batch: int) -> dict:
    """Strides and offsets (in floats) of the block's shared memory, and
    its size in bytes: each layer's working bias and weight rows (``dout``
    rounded up to 4 floats, plus 4: ``w_stride``), two gather buffers of
    width ``dims[0]`` (this step's rows and the next one's), an activation
    buffer per hidden width ``dims[l]``, 0 < l < L, a gradient buffer per
    width ``dims[l]``, l >= 1, each ``batch`` rows, and three rows of
    ``batch`` indices.  Every buffer starts on 16 bytes.  ``seg_off`` is
    each layer's offset in the ravel order of the flat params."""
    n_layers = len(dims) - 1
    if not 1 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"the kernel takes 1..{MAX_LAYERS} layers, got {n_layers}")
    stride = [_row_stride(dd) for dd in dims]
    seg_off, pseg_off, w_off, w_stride = [], [], [], []
    seg = off = 0
    for a, b in zip(dims[:-1], dims[1:]):
        seg_off.append(seg)
        seg += a * b + b
        pseg_off.append(off)
        w_off.append(off + _align4(b))
        w_stride.append(_align4(b) + 4)
        off = w_off[-1] + a * w_stride[-1]
    x_off = [off, off + batch * stride[0]]
    off += 2 * batch * stride[0]
    act_off = [0] * (n_layers + 1)
    for li in range(1, n_layers):
        act_off[li] = off
        off += batch * stride[li]
    grad_off = [0] * (n_layers + 1)
    for li in range(1, n_layers + 1):
        grad_off[li] = off
        off += batch * stride[li]
    idx_off = off
    off += 3 * batch
    smem = 4 * off
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"autoencoder widths {dims} at batch {batch} need {smem} B of shared "
            f"memory per client; the kernel has {SMEM_LIMIT}"
        )
    return dict(stride=stride, seg_off=seg_off, pseg_off=pseg_off, w_off=w_off,
                w_stride=w_stride, x_off=x_off, act_off=act_off, grad_off=grad_off,
                idx_off=idx_off, n_params=seg, smem=smem)


def train_clients(
    x: torch.Tensor,                  # (N, window, D) f32 client windows
    idx: torch.Tensor,                # (N, steps, batch) int32 window rows
    theta: torch.Tensor,              # (d,) or (B, d) f32 start params, ravel order
    dims: tuple[int, ...],            # (D, hidden..., D)
    lr: float,
    mu: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``local_train_f32``: (deltas (N, d) f32 in the ravel order,
    mean loss (N,) f32).  Index entries must lie in ``[0, window)``.  A
    (B, d) ``theta`` holds one start vector per trial: the N = B * (N / B)
    clients are B runs, run b training from ``theta[b]``."""
    device = _launch.require_cuda(x, "local-train")
    dims = tuple(int(v) for v in dims)
    if x.dim() != 3 or idx.dim() != 3:
        raise ValueError(f"x must be (N, window, D) and idx (N, steps, batch), got "
                         f"{tuple(x.shape)} and {tuple(idx.shape)}")
    n, window, d = x.shape
    if dims[0] != d or dims[-1] != d:
        raise ValueError(f"the autoencoder must map D={d} to itself, got widths {dims}")
    steps, batch = int(idx.shape[1]), int(idx.shape[2])
    if n < 1 or steps < 1 or batch < 1:
        raise ValueError(f"needs a client and a step of a row, got idx {tuple(idx.shape)}")
    lay = layout(dims, batch)
    _launch.check(x, "x", torch.float32, (n, window, d), device)
    _launch.check(idx, "idx", torch.int32, (n, steps, batch), device)
    trials = int(theta.shape[0]) if theta.dim() == 2 else 1
    if trials < 1 or n % trials != 0:
        raise ValueError(f"theta {tuple(theta.shape)} does not split {n} clients into trials")
    _launch.check(theta, "theta", torch.float32,
                  (trials, lay["n_params"]) if theta.dim() == 2 else (lay["n_params"],), device)
    deltas = torch.empty((n, lay["n_params"]), dtype=torch.float32, device=device)
    loss = torch.empty((n,), dtype=torch.float32, device=device)
    lib = _library()
    ints = lambda v: (ctypes.c_int * len(v))(*v)  # noqa: E731
    with torch.cuda.device(device):
        rc = lib.local_train_f32(
            x.data_ptr(), n, window, idx.data_ptr(), steps, batch, theta.data_ptr(),
            n // trials, len(dims) - 1, ints(dims),
            ints(lay["seg_off"] + lay["pseg_off"] + lay["w_off"] + lay["w_stride"]),
            ints(lay["stride"] + lay["act_off"] + lay["grad_off"]), ints(lay["x_off"]),
            lay["idx_off"], lay["n_params"], float(lr), float(mu), deltas.data_ptr(),
            loss.data_ptr(), lay["smem"], _launch.stream(device),
        )
    _launch.raise_on(rc, "local_train_f32 launch", lib.local_train_error_string)
    LAUNCHES["local_train_f32"] += 1
    return deltas, loss

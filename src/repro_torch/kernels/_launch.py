"""What the launch wrappers of the port share: input checks, the error
raise after a launch and the current stream."""
from __future__ import annotations

from typing import Callable

import torch

TASK_LIMIT = 2 ** 31    # a launch's (row, block) tasks: its grid and task index are int


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    if t.device == device and t.dtype == dtype and t.shape == shape and t.is_contiguous():
        return   # the common case, in one test: the launch wrappers' host cost
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_cuda(t: torch.Tensor, what: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"the {what} kernel takes CUDA tensors, got one on {t.device}")
    return t.device


def rows(x: torch.Tensor, what: str, block: int) -> tuple[torch.device, int, int, int]:
    """(device, N, d, blocks of ``block`` per row) of a CUDA (N, d) input;
    raises on anything else.  A row may hold 2^31 coordinates or more (the
    C entries take d as a 64-bit integer); the launch takes one task per
    (row, block), so N x blocks must stay below 2^31."""
    device = require_cuda(x, what)
    if x.dim() != 2:
        raise ValueError(f"the {what} kernel takes (N, d) rows, got {tuple(x.shape)}")
    n, d = (int(s) for s in x.shape)
    if n < 1 or d < 1:
        raise ValueError(f"needs N, d >= 1, got N={n}, d={d}")
    nb = -(-d // block)
    if n * nb >= TASK_LIMIT:
        raise ValueError(f"the {what} kernel takes N x blocks below 2^31 (one launch task per "
                         f"(row, {block}-block), an int index), got N={n} x {nb} blocks")
    return device, n, d, nb


def raise_on(rc: int, what: str, error_string: Callable[[int], bytes]) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({error_string(rc).decode()})")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream

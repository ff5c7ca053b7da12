"""Launch wrapper of the sliding-window decode-attention kernel
(``csrc/swa_decode.cu``).

:func:`swa_decode` (``swa_decode``, one call for the whole batch) takes
CUDA tensors only: q (B, Hq, d), the caches (B, S, Hkv, d), all f32 or all
bf16, cache_len (B,) int32 and an int window; it returns (B, Hq, d) in q's
dtype.  It checks its inputs, allocates the output and the split scratch
with ``torch.empty``, launches on the current stream, raises on a launch
error and adds one to ``LAUNCHES["swa_decode"]``.  The CPU route is
``kernels/ops``', which sends CPU tensors to
``kernels/ref.sliding_window_decode_attention_ref``, the plain version of
the same function.  :func:`swa_decode_work` counts the bytes and
operations one call needs for the bound.

Design (flash-decoding): each row's window is cut into ``splits`` runs of
``chunk`` positions (:func:`plan`, from the shapes alone, never from
``cache_len``); one block per (row, kv head, up to 16 query heads, split)
walks its run in tiles of 32 positions staged by ``cp.async``, with the
scores and P . V on the tensor cores for bf16 (CUDA cores for f32), and
writes its partial softmax state to f32 scratch; a second launch
(``swa_merge_kernel``) combines the splits in order.  So one call is two
device launches, and two calls on the same inputs are bitwise equal.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _launch

LAUNCHES = {"swa_decode": 0}
MAX_HEAD_DIM = 256
TILE = 32            # positions per tile (kTile in csrc/swa_decode.cu)
HEAD_CHUNK = 16      # query heads per block (kMaxHeads)
TARGET_BLOCKS = 264  # two blocks on each of the H100's 132 SMs

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    LAUNCHES["swa_decode"] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("swa_decode")
        vp, i = ctypes.c_void_p, ctypes.c_int
        ll = ctypes.c_longlong
        lib.swa_decode.argtypes = [vp, vp, vp, vp, i, i, i, i, i, ll, ll, i,
                                   ctypes.c_float, i, vp, vp, vp, vp]
        lib.swa_decode.restype = i
        lib.swa_decode_error_string.argtypes = [i]
        lib.swa_decode_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _shapes(q: torch.Tensor, k_cache: torch.Tensor) -> tuple[int, int, int, int, int]:
    """(B, Hq, S, Hkv, d) of a decode call; raises on shapes the kernel
    does not take."""
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"needs q (B, Hq, d) and caches (B, S, Hkv, d), got "
                         f"{tuple(q.shape)} and {tuple(k_cache.shape)}")
    b, hq, d = (int(x) for x in q.shape)
    s, hkv = int(k_cache.shape[1]), int(k_cache.shape[2])
    if hkv < 1 or hq % hkv != 0:
        raise ValueError(f"Hq = {hq} is not a multiple of Hkv = {hkv}")
    if d % 32 != 0 or not 32 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be a multiple of 32 up to {MAX_HEAD_DIM}, got {d}")
    if b < 1 or s < 1:
        raise ValueError(f"needs B, S >= 1, got B={b}, S={s}")
    return b, hq, s, hkv, d


def plan(b: int, hq: int, s: int, hkv: int, window: int) -> tuple[int, int]:
    """(splits, chunk) of a call: each row's window, at most ``min(S,
    window)`` positions, cut into ``splits`` runs of ``chunk`` positions (a
    multiple of :data:`TILE`), so that the grid of ``B * Hkv * ceil(g /
    16) * splits`` blocks comes near :data:`TARGET_BLOCKS`.  A function of
    the shapes alone: the kernel reads the lengths on the device."""
    span = min(int(s), int(window))
    rows = b * hkv * -(-(hq // hkv) // HEAD_CHUNK)
    tiles = -(-span // TILE)
    splits = min(tiles, max(1, -(-TARGET_BLOCKS // rows)))
    chunk = TILE * -(-tiles // splits)
    return -(-span // chunk), chunk


def split_ranges(length: int, s: int, window: int, splits: int,
                 chunk: int) -> list[tuple[int, int]]:
    """The positions [start, end) that split z of a row of ``length``
    attends to, for z in order (empty where end <= start): the kernel's
    own arithmetic."""
    lo, hi = max(0, length - int(window)), min(length, s)
    return [(lo + z * chunk, min(hi, lo + (z + 1) * chunk)) for z in range(splits)]


def swa_decode(
    q: torch.Tensor,          # (B, Hq, d) f32 or bf16
    k_cache: torch.Tensor,    # (B, S, Hkv, d) as q
    v_cache: torch.Tensor,    # (B, S, Hkv, d) as q
    cache_len: torch.Tensor,  # (B,) int32
    window: int,
) -> torch.Tensor:
    """Launch ``swa_decode``: (B, Hq, d) in q's dtype; zeros for a row
    whose window holds no position."""
    device = _launch.require_cuda(q, "swa_decode")
    b, hq, s, hkv, d = _shapes(q, k_cache)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q is {q.dtype}, the kernel takes float32 or bfloat16")
    if int(window) < 1:
        raise ValueError(f"needs window >= 1, got {window}")
    _launch.check(q, "q", q.dtype, (b, hq, d), device)
    _launch.check(k_cache, "k_cache", q.dtype, (b, s, hkv, d), device)
    _launch.check(v_cache, "v_cache", q.dtype, (b, s, hkv, d), device)
    _launch.check(cache_len, "cache_len", torch.int32, (b,), device)
    if q.data_ptr() % 16 or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("q and the caches must start on a 16-byte boundary (cp.async)")
    splits, chunk = plan(b, hq, s, hkv, int(window))
    out = torch.empty_like(q)
    # One scratch allocation: acc (B Hq, splits, d), then (m, l) (B Hq, splits, 2).
    part = torch.empty(b * hq * splits * (d + 2), dtype=torch.float32, device=device)
    part_acc, part_ml = part[:b * hq * splits * d], part[b * hq * splits * d:]
    lib = _library()
    with torch.cuda.device(device):
        rc = lib.swa_decode(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                            cache_len.data_ptr(), b, s, hkv, hq // hkv, d, int(window),
                            chunk, splits, d ** -0.5, int(q.dtype == torch.bfloat16),
                            part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
                            _launch.stream(device))
        _launch.raise_on(rc, "swa_decode launch", lib.swa_decode_error_string)
        LAUNCHES["swa_decode"] += 1
    return out


def swa_decode_work(q: torch.Tensor, k_cache: torch.Tensor, cache_len: torch.Tensor,
                    window: int) -> tuple[int, int]:
    """(bytes, operations) one call needs on these inputs: each row's
    window of K and V read once, q and cache_len read, the output written;
    per position and query head 2 d for the score, 2 d for the weighted
    sum and 6 for the online softmax.  Reads cache_len on the host."""
    b, hq, s, hkv, d = _shapes(q, k_cache)
    n = sum(max(0, min(length, s) - max(0, length - int(window)))
            for length in cache_len.tolist())
    item = q.element_size()
    bytes_ = n * hkv * d * 2 * item + 2 * b * hq * d * item + b * 4
    return bytes_, n * hq * (4 * d + 6)

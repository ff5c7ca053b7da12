"""Launch wrappers of the compress-and-aggregate kernels
(``csrc/fused_agg.cu``): the dense fused path and the sparse wire.

:func:`compress_aggregate_blocks` takes CUDA tensors only: the (N, d)
client updates and error-feedback buffers, the (N,) fog assignment and
weights.  It checks them, allocates the outputs and its workspace (each
coordinate's int8 code, the fogs' member lists) with ``torch.empty`` and
makes the kernel's two launches on the current stream, laid out by
:func:`dense_plan`: ``select`` (the fogs' member lists, one block per
fog, beside the threshold, the int8 codes and new_err per client and
8192-element block, each block selected by a team sized to its real
width as ``wire_emit``'s) and ``sum`` (the per-fog weighted sums of code
* scale, a block per (fog, column tile), clients in index order from the
list).  Each launch adds one to ``LAUNCHES["fused_agg"]``.  The CPU route
is ``kernels/ops``', which sends CPU tensors to
``kernels/ref.compress_aggregate_ref``, the plain version of the same
function (it returns the same three tensors); ``kernels/ref.dense_fold_ref``
replays the kernel's summation order, bit for bit.

:func:`compress_wire_blocks` (``wire_emit``) makes the same survivor
selection and packs the survivors into k slots per block: int32 indices,
int8 codes (f32 values without quantisation) and one f32 scale per block,
beside new_err.  Each (client, block) goes to a team sized to the block's
real width (:func:`wire_plan`): ``SMALL_TEAM`` threads up to
``SMALL_WIDTH`` columns, else a block of ``TEAM_THREADS``; one launch, or
one of each when a row holds both kinds.  Its first call on a device opts
the kernels in to ``SMEM_MAX`` bytes of dynamic shared memory there.
:func:`wire_aggregate_blocks` (``wire_agg``, one launch, a warp per (fog,
block)) adds ``q * scale * w`` from the slots into fog sums, in place,
each coordinate taking its clients in index order.
Both write into caller-given buffers when asked, so a chunked round
writes each chunk's wire and error-feedback rows straight into slices of
the round's buffers.  Their plain versions are
``kernels/ref.compress_wire_ref`` and ``kernels/ref.wire_aggregate_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.ref import BLOCK_ELEMS   # kBlock in csrc/block_select.cuh
from repro_torch.kernels.teams import (SMALL_SLOTS, SMALL_TEAM, SMALL_WIDTH,  # noqa: F401
                                       TEAM_THREADS, compress_plan, sm_count,
                                       team_threads)  # noqa: F401 (re-exported)

LAUNCHES = {"fused_agg": 0, "wire_emit": 0, "wire_agg": 0}
SLOT_BYTES = 12            # shared memory per ranked survivor: a 64-bit key, an f32 value
RANK_PAD = 8               # kRankPad: pad keys after a team's ranked survivors
SMEM_MAX = TEAM_THREADS // SMALL_TEAM * (SLOT_BYTES * SMALL_WIDTH + 8 * RANK_PAD + 16)
SUM_THREADS = 128          # kSumThreads: threads of a fog-sum block
SUM_COLS = (4, 2, 1)       # its instances' columns a thread, widest first

_lib: ctypes.CDLL | None = None
_wire_ready: set[int] = set()   # devices whose wire_emit kernels are opted in


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("fused_agg")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_agg_select.argtypes = [vp, vp, vp, i, i, i, i, i, i, i, i, i,
                                         vp, vp, vp, vp, vp, vp, vp]
        lib.fused_agg_select.restype = i
        lib.fused_agg_sum.argtypes = [vp, vp, vp, vp, i, i, i, i, vp, vp, vp]
        lib.fused_agg_sum.restype = i
        lib.wire_emit.argtypes = [vp, vp, i, i, i, i, i, i, i, i, i, i, i, i, vp, vp, vp, vp, vp]
        lib.wire_emit.restype = i
        lib.wire_emit_init.argtypes = [i]
        lib.wire_emit_init.restype = i
        lib.wire_agg.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, vp, vp]
        lib.wire_agg.restype = i
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
    if n < 1 or d < 1 or n_fog < 1 or k < 1:
        raise ValueError(f"needs N, d, n_fog, k >= 1, got N={n}, d={d}, n_fog={n_fog}, k={k}")
    if n_fog >= 0x7FFFFFFF or (n_fog + 1) + n * -(-d // BLOCK_ELEMS) > 0x7FFFFFFF:
        raise ValueError(f"N={n} rows of d={d} into n_fog={n_fog} fogs need more blocks than "
                         "a grid holds")
    nb = -(-d // BLOCK_ELEMS)
    _launch.check(deltas, "deltas", torch.float32, (n, d), device)
    _launch.check(err, "err", torch.float32, (n, d), device)
    _launch.check(fog_id, "fog_id", torch.int32, (n,), device)
    _launch.check(weights, "weights", torch.float32, (n,), device)
    p = dense_plan(n, d, n_fog, sm_count(device))
    new_err = torch.empty((n, d), dtype=torch.float32, device=device)
    thr_scale = torch.empty((2, n, nb), dtype=torch.float32, device=device)
    fog_sum = torch.empty((n_fog, d), dtype=torch.float32, device=device)
    # One workspace (raw bytes, addressed by pointer: no views to build per
    # call): the (N, d) codes, int8 or f32, then the member list (N) and
    # the offsets (n_fog + 1), int32, 16-byte aligned.
    code_bytes = -(-n * d * (1 if quantize else 4) // 16) * 16
    work = torch.empty((code_bytes + 4 * (n + n_fog + 1),), dtype=torch.uint8, device=device)
    codes = work.data_ptr()
    members = codes + code_bytes
    offsets = members + 4 * n
    scale = thr_scale.data_ptr() + 4 * n * nb
    lib = _library()
    with torch.cuda.device(device):
        stream = _launch.stream(device)
        rc = lib.fused_agg_select(
            deltas.data_ptr(), err.data_ptr(), fog_id.data_ptr(), n, d, int(k), int(quantize),
            n_fog, p.n_wide, p.slots, p.teams, p.narrow_grid, new_err.data_ptr(),
            thr_scale.data_ptr(), scale, codes, members, offsets, stream,
        )
        _launch.raise_on(rc, "fused_agg select launch", lib.fused_agg_error_string)
        LAUNCHES["fused_agg"] += 1
        rc = lib.fused_agg_sum(
            codes, members, offsets, weights.data_ptr(), d, n_fog, int(quantize), p.cols, scale,
            fog_sum.data_ptr(), stream,
        )
        _launch.raise_on(rc, "fused_agg sum launch", lib.fused_agg_error_string)
        LAUNCHES["fused_agg"] += 1
    return fog_sum, new_err, thr_scale[0]


class WirePlan(NamedTuple):
    """``wire_emit``'s launches: N * n_wide blocks of block teams, then
    narrow_grid blocks of small teams."""
    n_wide: int        # blocks of each row run by a block team (the first ones)
    cap_wide: int      # ranked survivors a block team keeps in shared memory
    smem_wide: int     # its dynamic shared memory, bytes
    slots: int         # slots a thread of a small team: its held width over SMALL_TEAM
    threads: int       # threads per block of small teams
    narrow_grid: int   # blocks of small teams (0: the last block is wide too)
    cap_narrow: int    # ranked survivors a small team keeps in shared memory
    smem_narrow: int   # a block of small teams' dynamic shared memory, bytes


def team_region(held: int, cap: int) -> int:
    """Bytes of a team's shared region (``wire_region`` in
    csrc/fused_agg.cu): its bisection candidates (4 bytes for each of its
    ``held`` elements), later its keys and values (``SLOT_BYTES`` each of
    ``cap``, and ``RANK_PAD`` pad keys), in 16-byte units with one to
    spare."""
    return 16 * (max(4 * held, SLOT_BYTES * cap + 8 * RANK_PAD) // 16 + 1)


@functools.lru_cache(maxsize=256)
def wire_plan(n: int, d: int, k: int, n_sm: int) -> WirePlan:
    """Teams and grid of ``wire_emit`` for N = ``n`` rows of ``d`` on
    ``n_sm`` SMs (``teams.compress_plan``), one launch per team size.  A
    team keeps at most min(k, width) ranked survivors in shared memory."""
    p = compress_plan(n, d, n_sm)
    cap_wide = min(k, BLOCK_ELEMS) if p.n_wide else 0
    smem_wide = team_region(BLOCK_ELEMS, cap_wide) if p.n_wide else 0
    if not p.narrow_grid:
        return WirePlan(p.n_wide, cap_wide, smem_wide, 0, 0, 0, 0, 0)
    cap_narrow = min(k, d - p.n_wide * BLOCK_ELEMS)
    return WirePlan(p.n_wide, cap_wide, smem_wide, p.slots, SMALL_TEAM * p.teams, p.narrow_grid,
                    cap_narrow, p.teams * team_region(SMALL_TEAM * p.slots, cap_narrow))


class DensePlan(NamedTuple):
    """``fused_agg``'s launches: the select launch (n_fog + 1 list blocks,
    N * n_wide block teams, narrow_grid blocks of ``teams`` small teams of
    ``slots`` slots a thread), then n_fog * ceil(d / (SUM_THREADS * cols))
    fog-sum blocks."""
    n_wide: int        # blocks of each row run by a block team (the first ones)
    slots: int         # slots a thread of a small team (SMALL_SLOTS[0] when there is none)
    teams: int         # small teams a block of the select launch
    narrow_grid: int   # blocks of small teams (0: the last block is wide too)
    cols: int          # columns a thread of a fog-sum block


@functools.lru_cache(maxsize=256)
def dense_plan(n: int, d: int, n_fog: int, n_sm: int) -> DensePlan:
    """Teams of the select launch (``teams.compress_plan``, ``wire_emit``'s)
    and the fog sums' tile for N = ``n`` rows of ``d`` into ``n_fog`` fogs
    on ``n_sm`` SMs: the widest of ``SUM_COLS`` columns a thread whose
    tiles are no wider than the row and still give one block per SM or more
    (train-200's 20 fogs of d = 1,352: one, 11 tiles, 220 blocks), else
    one."""
    cols = next((c for c in SUM_COLS if SUM_THREADS * c <= max(d, SUM_THREADS)
                 and n_fog * -(-d // (SUM_THREADS * c)) >= n_sm), 1)
    return DensePlan(*compress_plan(n, d, n_sm), cols)


def _opt_in_wire(device: torch.device) -> None:
    """Opts ``wire_emit`` in to ``SMEM_MAX`` bytes of dynamic shared memory
    on ``device``, once."""
    if device.index not in _wire_ready:
        lib = _library()
        with torch.cuda.device(device):
            _launch.raise_on(lib.wire_emit_init(SMEM_MAX), "wire_emit_init",
                             lib.fused_agg_error_string)
        _wire_ready.add(device.index)


def _wire_outputs(n: int, nb: int, k: int, d: int, quantize: bool, device: torch.device,
                  out: tuple | None) -> tuple:
    code = torch.int8 if quantize else torch.float32
    shapes = ((n, nb, k), (n, nb, k), (n, nb), (n, d))
    dtypes = (torch.int32, code, torch.float32, torch.float32)
    if out is None:
        return tuple(torch.empty(s, dtype=t, device=device) for s, t in zip(shapes, dtypes))
    for t, name, dtype, shape in zip(out, ("idx", "q", "scale", "new_err"), dtypes, shapes):
        _launch.check(t, name, dtype, shape, device)
    return tuple(out)


def compress_wire_blocks(
    deltas: torch.Tensor,     # (N, d) f32 raw client updates
    err: torch.Tensor,        # (N, d) f32 error-feedback buffers
    k: int,                   # slots per 8192-element block
    quantize: bool = True,
    out: tuple | None = None,  # (idx, q, scale, new_err) to write into
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``wire_emit``: (idx (N, nb, k) int32, q (N, nb, k) int8 — f32
    without ``quantize`` — scale (N, nb) f32, new_err (N, d)).  ``out``
    gives contiguous buffers of those shapes (row slices of a round's
    buffers are), written in place and returned."""
    device = _launch.require_cuda(deltas, "wire emit")
    if deltas.dim() != 2:
        raise ValueError(f"deltas must be (N, d), got {tuple(deltas.shape)}")
    n, d = (int(s) for s in deltas.shape)
    if n < 1 or d < 1 or not 1 <= k <= BLOCK_ELEMS:
        raise ValueError(f"needs N, d >= 1 and 1 <= k <= {BLOCK_ELEMS}, got N={n}, d={d}, k={k}")
    nb = -(-d // BLOCK_ELEMS)
    _launch.check(deltas, "deltas", torch.float32, (n, d), device)
    _launch.check(err, "err", torch.float32, (n, d), device)
    idx, q, scale, new_err = _wire_outputs(n, nb, k, d, quantize, device, out)
    _opt_in_wire(device)
    p = wire_plan(n, d, int(k), sm_count(device))
    if n * p.n_wide > 0x7FFFFFFF:
        raise ValueError(f"N={n} rows of d={d} need {n * p.n_wide} blocks, more than a grid holds")
    lib = _library()
    with torch.cuda.device(device):
        rc = lib.wire_emit(
            deltas.data_ptr(), err.data_ptr(), n, d, int(k), int(quantize), p.n_wide, p.cap_wide,
            p.smem_wide, p.slots, p.threads, p.narrow_grid, p.cap_narrow, p.smem_narrow,
            idx.data_ptr(), q.data_ptr(), scale.data_ptr(), new_err.data_ptr(),
            _launch.stream(device),
        )
        _launch.raise_on(rc, "wire_emit launch", lib.fused_agg_error_string)
        LAUNCHES["wire_emit"] += 1
    return idx, q, scale, new_err


def wire_aggregate_blocks(
    idx: torch.Tensor,        # (N, nb, k) int32 within-block coordinates
    q: torch.Tensor,          # (N, nb, k) int8 codes, or f32 values
    scale: torch.Tensor,      # (N, nb) f32 per-block scales
    fog_id: torch.Tensor,     # (N,) int32 cluster assignment
    weights: torch.Tensor,    # (N,) f32, zeroed for non-participants
    n_fog: int,
    d: int,
    out: torch.Tensor | None = None,   # (n_fog, d) f32 running sums, added to in place
) -> torch.Tensor:
    """Launch ``wire_agg``: fog_sum (n_fog, d) f32 += the weighted wire of
    these N clients, each coordinate summing its clients in index order
    after the value already there.  ``out`` is updated in place (rows of
    fogs without a client here are untouched); without it the sums start
    from zeros.  Against the plain version, which scatter-adds in another
    order: ``rtol=1e-5, atol=1e-4``."""
    device = _launch.require_cuda(idx, "wire aggregate")
    if idx.dim() != 3:
        raise ValueError(f"idx must be (N, nb, k), got {tuple(idx.shape)}")
    n, nb, k = (int(s) for s in idx.shape)
    in_blocks = (nb - 1) * BLOCK_ELEMS < d <= nb * BLOCK_ELEMS
    if n < 1 or k < 1 or n_fog < 1 or not in_blocks:
        raise ValueError(f"needs N, k, n_fog >= 1 and d within the {nb} blocks, "
                         f"got N={n}, k={k}, n_fog={n_fog}, d={d}")
    if q.dtype not in (torch.int8, torch.float32):
        raise TypeError(f"q is {q.dtype}, expected torch.int8 or torch.float32")
    _launch.check(idx, "idx", torch.int32, (n, nb, k), device)
    _launch.check(q, "q", q.dtype, (n, nb, k), device)
    _launch.check(scale, "scale", torch.float32, (n, nb), device)
    _launch.check(fog_id, "fog_id", torch.int32, (n,), device)
    _launch.check(weights, "weights", torch.float32, (n,), device)
    if out is None:
        out = torch.zeros((n_fog, d), dtype=torch.float32, device=device)
    else:
        _launch.check(out, "out", torch.float32, (n_fog, d), device)
    lib = _library()
    with torch.cuda.device(device):
        rc = lib.wire_agg(
            idx.data_ptr(), q.data_ptr(), scale.data_ptr(), fog_id.data_ptr(),
            weights.data_ptr(), n, nb, k, int(d), n_fog, int(q.dtype == torch.int8),
            out.data_ptr(), _launch.stream(device),
        )
        _launch.raise_on(rc, "wire_agg launch", lib.fused_agg_error_string)
        LAUNCHES["wire_agg"] += 1
    return out

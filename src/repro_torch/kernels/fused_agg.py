"""Launch wrappers of the compress-and-aggregate kernels
(``csrc/fused_agg.cu``): the dense fused path and the sparse wire.

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

:func:`compress_wire_blocks` (``wire_emit``) makes the same survivor
selection and packs the survivors into k slots per block: int32 indices,
int8 codes (f32 values without quantisation) and one f32 scale per block,
beside new_err.  Each (client, block) goes to a team sized to the block's
real width (:func:`wire_plan`): ``SMALL_TEAM`` threads up to
``SMALL_WIDTH`` columns, else a block of ``TEAM_THREADS``; one launch, or
one of each when a row holds both kinds.  Its first call on a device opts
the kernels in to ``SMEM_MAX`` bytes of dynamic shared memory there and
reads the SM count.  :func:`wire_aggregate_blocks` (``wire_agg``, one
launch, a warp per (fog, block)) adds ``q * scale * w`` from the slots
into fog sums, in place, each coordinate taking its clients in index
order.
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
from repro_torch.kernels.ref import BLOCK_ELEMS   # kBlock in csrc/fused_agg.cu

LAUNCHES = {"fused_agg": 0, "wire_emit": 0, "wire_agg": 0}
SMALL_WIDTH = 2048         # kSmallWidth in csrc/block_select.cuh: a small team's widest block
SMALL_TEAM = 64            # kNarrowTeam in csrc/fused_agg.cu: a small team's threads
SMALL_SLOTS = (8, 16, 24, 32)   # its kernels' slots a thread, SMALL_TEAM * slots held
TEAM_THREADS = 256         # kThreads: a block team, and the block of a launch
SLOT_BYTES = 12            # shared memory per ranked survivor: a 64-bit key, an f32 value
RANK_PAD = 8               # kRankPad: pad keys after a team's ranked survivors
SMEM_MAX = TEAM_THREADS // SMALL_TEAM * (SLOT_BYTES * SMALL_WIDTH + 8 * RANK_PAD + 16)

_lib: ctypes.CDLL | None = None
_n_sm: dict[int, int] = {}  # device index -> SM count, once wire_emit is opted in


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("fused_agg")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_agg_select.argtypes = [vp, vp, i, i, i, i, vp, vp, vp, vp]
        lib.fused_agg_select.restype = i
        lib.fused_agg_sum.argtypes = [vp, vp, vp, vp, i, i, i, i, vp, vp, vp, vp]
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


def team_threads(width: int) -> int:
    """Threads of the team that selects a block of ``width`` real columns."""
    return SMALL_TEAM if width <= SMALL_WIDTH else TEAM_THREADS


@functools.lru_cache(maxsize=256)
def wire_plan(n: int, d: int, k: int, n_sm: int) -> WirePlan:
    """Teams and grid of ``wire_emit`` for N = ``n`` rows of ``d`` on
    ``n_sm`` SMs.  Only a row's last block can be narrower than
    ``BLOCK_ELEMS``; when it is at most ``SMALL_WIDTH`` wide it goes to a
    small team, and the launch packs as many small teams a block (a power
    of two up to ``TEAM_THREADS // SMALL_TEAM``) as keep one block per SM
    or more, each thread holding the fewest of ``SMALL_SLOTS`` slots that
    cover the width.  Every other block goes to a block team.  A team keeps
    at most min(k, width) ranked survivors in shared memory."""
    nb = -(-d // BLOCK_ELEMS)
    tail = d - (nb - 1) * BLOCK_ELEMS
    narrow = team_threads(tail) == SMALL_TEAM
    n_wide = nb - 1 if narrow else nb
    cap_wide = min(k, BLOCK_ELEMS) if n_wide else 0
    smem_wide = team_region(BLOCK_ELEMS, cap_wide) if n_wide else 0
    if not narrow:
        return WirePlan(n_wide, cap_wide, smem_wide, 0, 0, 0, 0, 0)
    slots = next(s for s in SMALL_SLOTS if SMALL_TEAM * s >= tail)
    teams = TEAM_THREADS // SMALL_TEAM
    while teams > 1 and -(-n // teams) < n_sm:
        teams //= 2
    cap_narrow = min(k, tail)
    return WirePlan(n_wide, cap_wide, smem_wide, slots, SMALL_TEAM * teams, -(-n // teams),
                    cap_narrow, teams * team_region(SMALL_TEAM * slots, cap_narrow))


def _sm_count(device: torch.device) -> int:
    """SM count of ``device``; its first call there opts ``wire_emit`` in to
    ``SMEM_MAX`` bytes of dynamic shared memory."""
    n_sm = _n_sm.get(device.index)
    if n_sm is None:
        lib = _library()
        with torch.cuda.device(device):
            _launch.raise_on(lib.wire_emit_init(SMEM_MAX), "wire_emit_init",
                             lib.fused_agg_error_string)
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        _n_sm[device.index] = n_sm
    return n_sm


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
    p = wire_plan(n, d, int(k), _sm_count(device))
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

"""Operations and bytes of the port's round kernels, and the H100's peaks.

Frozen copy of the work arithmetic in ``chip_smoke.py`` at commit
503575e07401e7f10a9c0026dea9d563d82ebbba (``train_work``, ``agg_work``,
``robust_work``, ``wire_emit_work``, ``wire_agg_work``, ``bound_from`` and
the two peaks), kept here so that the yardstick stays fixed when the
program changes.  Two departures: ``robust_work`` and ``wire_agg_work``
take the member counts and the touched (fog, column) pairs as numbers,
counted by the benchmark's reference (``reference/hfl.py``) from its own
association and its own wire, and ``bound_from`` returns seconds.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 data sheet, dense rates: f32 on the CUDA cores, HBM3.
PEAK_F32_FLOP_S = 67e12
PEAK_BYTES_S = 3.35e12
BLOCK_ELEMS = 8192


def train_work(dims, n, window, steps, batch, prox) -> tuple[int, int]:
    """(bytes, operations) of one local-train call: windows, index table
    and params read once, deltas and losses written once; per step and
    client, matmul FMAs count 2 (forward, weight gradients, the input
    gradients of layers 1..L-1), bias adds, tanh, the loss and output
    gradient (4 per output), tanh' (3 per hidden unit), bias-gradient sums,
    and the update (2 per parameter, 5 with FedProx)."""
    layers = list(zip(dims[:-1], dims[1:]))
    mm = sum(a * b for a, b in layers)
    outs = sum(b for _, b in layers)
    hidden = sum(dims[1:-1])
    n_params = mm + outs
    bytes_ = 4 * (n * window * dims[0] + n * steps * batch + n_params + n * n_params + n)
    per_step = (batch * (2 * mm + outs + hidden + 4 * dims[0])
                + batch * (2 * (mm - dims[0] * dims[1]) + 3 * hidden)
                + batch * (2 * mm + outs)
                + (5 if prox else 2) * n_params)
    return bytes_, per_step * steps * n


def agg_work(n, d, n_fog) -> tuple[int, int]:
    """(bytes, operations) of one compress-aggregate call: deltas, error
    buffers, fog ids and weights read once, new error buffers and fog sums
    written once (the zero padding is counted, not loaded); per real
    coordinate the add, |v|, 32 bisection compares and count adds, the
    int8 round trip (divide, round, two clamps, multiply), the residual and
    the weighted fog add (2)."""
    return 4 * (3 * n * d + 2 * n + n_fog * d), n * d * (2 + 2 * 32 + 5 + 1 + 2)


def robust_work(members, n, n_fog, d) -> tuple[int, int]:
    """(bytes, operations) of one robust reduce of ``n`` clients into
    ``n_fog`` fogs whose member counts (weight > 0) are ``members``: recon,
    ids and weights read once, the fog rows written once; per column, each
    ordered pair of members of a fog takes two compares, two selects and
    two adds, and each member its ratio, eff and the num / den updates
    (9)."""
    ops = sum(m * m for m in members) * d * 6 + sum(members) * d * 9
    return 4 * (n * d + 2 * n + n_fog * d), int(ops)


def wire_emit_work(n, d, k, quantize) -> tuple[int, int]:
    """(bytes, operations) of one wire emit: deltas and error buffers read
    once, new_err, the slots (int32 index + int8 code, or f32 value) and
    the block scales written once; per real coordinate what
    :func:`agg_work` counts short of the fog add, plus one to pack."""
    nb = -(-d // BLOCK_ELEMS)
    return (4 * 3 * n * d + n * nb * k * (5 if quantize else 8) + 4 * n * nb,
            n * d * (2 + 2 * 32 + 5 + 1 + 1))


def wire_agg_work(n, nb, k, real_slots, touched, quantize) -> tuple[int, int]:
    """(bytes, operations) of one wire aggregate of ``n`` clients' (nb, k)
    slots into running sums: the slots, scales, ids and weights read once,
    and each of the ``touched`` fog coordinates read and written once; per
    slot within the real columns (``real_slots``) two multiplies and an
    add."""
    return (n * nb * k * (5 if quantize else 8) + 4 * n * nb + 8 * n + 8 * touched,
            3 * real_slots)


def bound_from(bytes_, ops) -> tuple[float, str]:
    """(the least seconds the card could take, the term that sets it)."""
    t_bytes, t_ops = bytes_ / PEAK_BYTES_S, ops / PEAK_F32_FLOP_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

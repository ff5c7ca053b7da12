"""Streaming threshold calibration for the online serving path.

The offline protocol (``core/anomaly.calibrate_threshold``) takes the 99th
percentile of ONE normal-only validation window (Eq. 32).  A long-running
service instead sees an unbounded validation stream, so thresholds here are
maintained over fixed-capacity uniform reservoirs (Vitter's Algorithm R) —
one per fog cluster plus one global — and read out as linearly-interpolated
percentiles of the reservoir contents.

Exactness contract: while a group has seen at most ``capacity`` errors the
reservoir holds *all* of them, and :func:`threshold` reproduces
``numpy.percentile`` (linear interpolation, f32 arithmetic as in the JAX
package) — the one-shot calibration is the ``count <= capacity`` special
case.  Beyond that the reservoir is a uniform sample and the threshold
converges to the stream percentile at the usual O(1/sqrt(capacity)) rate.

Drift survival: the optional ``horizon`` caps the effective count in the
replacement draw, so each new value replaces a uniform slot with
probability at least ``capacity / (horizon + 1)``: an exponentially-decayed
sample concentrated on roughly the last ``horizon`` observations.
``horizon=None`` keeps the uniform behaviour (``LEGACY_HORIZON``).

Algorithm R is sequential and off the hot path, so the state lives on the
host (numpy) and the replacement draws come from a CPU ``torch.Generator``
in one bulk draw per batch: no device op per validation error.  The draws
differ from ``jax.random``'s, so past capacity the two packages keep
different (equally uniform) samples.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

# "Uniform forever" sentinel for ``horizon``: min(count, LEGACY_HORIZON) ==
# count for any reachable count.
LEGACY_HORIZON = 2**30


class ReservoirState(NamedTuple):
    """Per-group reservoirs; the LAST row is the global (all-errors) group,
    rows [0, n_fog) are the per-fog groups."""

    buffer: np.ndarray              # (n_fog + 1, capacity) f32
    count: np.ndarray               # (n_fog + 1,) int64 — total errors observed
    generator: torch.Generator      # replacement draws (advanced in place)
    horizon: int                    # decay horizon (LEGACY_HORIZON = uniform)


def _host(a: Any, dtype) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype).reshape(-1)


def init(
    generator: torch.Generator, capacity: int, n_fog: int = 0,
    horizon: int | None = None,
) -> ReservoirState:
    groups = n_fog + 1
    return ReservoirState(
        buffer=np.zeros((groups, capacity), np.float32),
        count=np.zeros((groups,), np.int64),
        generator=generator,
        horizon=LEGACY_HORIZON if horizon is None else int(horizon),
    )


def update(
    state: ReservoirState,
    errors: Any,             # (B,) validation reconstruction errors
    fog_id: Any = None,      # (B,) int, optional fog routing
) -> ReservoirState:
    """Fold a batch of validation errors into the reservoirs.

    Every error feeds the global group; with ``fog_id`` it also feeds that
    fog's group.  Non-finite errors never enter a reservoir or advance its
    count, though each event still consumes its two draws.  Returns a new
    state (buffers copied; the generator is advanced in place).
    """
    errors = _host(errors, np.float32)
    fid = None if fog_id is None else _host(fog_id, np.int64)
    buffer, count = state.buffer.copy(), state.count.copy()
    cap = buffer.shape[1]
    g_global = buffer.shape[0] - 1
    u = torch.rand(
        (errors.shape[0], 2), generator=state.generator, dtype=torch.float64
    ).numpy()

    def row_update(g: int, v: float, draw: float) -> None:
        # Slot count[g] while filling, then a uniform slot in
        # [0, min(count, horizon)], kept when it lands inside the buffer.
        c = int(count[g])
        pos = c if c < cap else int(draw * (min(c, state.horizon) + 1))
        if pos < cap:
            buffer[g, pos] = v
        count[g] += 1

    finite = np.isfinite(errors)
    for i in range(errors.shape[0]):
        if not finite[i]:
            continue
        row_update(g_global, errors[i], u[i, 0])
        if fid is not None:
            row_update(int(fid[i]), errors[i], u[i, 1])
    return ReservoirState(buffer, count, state.generator, state.horizon)


def threshold(state: ReservoirState, percentile: float = 99.0) -> torch.Tensor:
    """Per-group thresholds: (n_fog + 1,) f32 with the global tau last.

    Linearly-interpolated percentile of each group's valid reservoir
    entries, in f32 like the JAX package.  Groups that have seen nothing
    return +inf, so an uncalibrated fog flags no anomalies.
    """
    cap = state.buffer.shape[1]
    n_valid = np.minimum(state.count, cap)                     # (G,)
    masked = np.where(
        np.arange(cap)[None, :] < n_valid[:, None], state.buffer, np.float32(np.inf)
    )
    srt = np.sort(masked, axis=-1)
    frac_p = np.float32(percentile) / np.float32(100.0)
    q = np.maximum((n_valid - 1).astype(np.float32) * frac_p, np.float32(0.0))
    lo = np.floor(q).astype(np.int64)
    hi = np.minimum(lo + 1, np.maximum(n_valid - 1, 0))
    frac = q - lo.astype(np.float32)
    rows = np.arange(srt.shape[0])
    v_lo, v_hi = srt[rows, lo], srt[rows, hi]
    with np.errstate(invalid="ignore"):       # inf - inf on empty groups
        out = v_lo + frac * (v_hi - v_lo)
    out = np.where(n_valid > 0, out, np.float32(np.inf)).astype(np.float32)
    return torch.from_numpy(out)


class StreamingCalibrator:
    """Stateful wrapper the service loop drives.

    ``observe`` feeds validation errors (optionally fog-routed); ``taus``
    returns the (n_fog + 1,) thresholds with the global one last, and the
    ``global_tau`` / ``fog_taus`` accessors split that for callers.

    ``horizon`` enables the decayed reservoir mode (see module docstring);
    ``psi`` is a host-side population-stability-index drift signal: the
    first ``psi_window`` finite errors freeze a reference histogram
    (deciles by default), the latest ``psi_window`` errors form the
    comparison window, and ``sum((p - q) ln(p / q))`` over the bins scores
    the shift.  The usual reading: < 0.1 stable, 0.1-0.25 moderate drift,
    > 0.25 the thresholds' world has moved.
    """

    def __init__(
        self,
        capacity: int = 4096,
        n_fog: int = 0,
        percentile: float = 99.0,
        seed: int = 0,
        horizon: int | None = None,
        psi_window: int = 512,
        psi_bins: int = 10,
    ):
        self.percentile = float(percentile)
        self.n_fog = int(n_fog)
        self.state = init(torch.Generator().manual_seed(seed), capacity, n_fog, horizon)
        self.psi_window = int(psi_window)
        self.psi_bins = int(psi_bins)
        self._ref: np.ndarray | None = None     # frozen reference sample
        self._ref_edges: np.ndarray | None = None
        self._recent: np.ndarray = np.zeros((0,), np.float32)

    def observe(self, errors: Any, fog_id: Any = None) -> None:
        self.state = update(self.state, errors, fog_id)
        e = _host(errors, np.float32)
        e = e[np.isfinite(e)]
        if e.size == 0:
            return
        self._recent = np.concatenate([self._recent, e])[-self.psi_window:]
        if self._ref is None and self._recent.size >= self.psi_window:
            self._ref = self._recent.copy()
            qs = np.linspace(0.0, 100.0, self.psi_bins + 1)[1:-1]
            self._ref_edges = np.percentile(self._ref, qs)

    def psi(self) -> float:
        """Population stability index of the recent-error histogram vs the
        frozen reference (0.0 until both windows exist)."""
        if self._ref_edges is None or self._recent.size < self.psi_window:
            return 0.0
        ref_hist = np.histogram(self._ref, bins=np.r_[
            -np.inf, self._ref_edges, np.inf
        ])[0]
        cur_hist = np.histogram(self._recent, bins=np.r_[
            -np.inf, self._ref_edges, np.inf
        ])[0]
        eps = 1e-4
        p = ref_hist / max(ref_hist.sum(), 1) + eps
        q = cur_hist / max(cur_hist.sum(), 1) + eps
        p, q = p / p.sum(), q / q.sum()
        return float(np.sum((p - q) * np.log(p / q)))

    def taus(self) -> torch.Tensor:
        return threshold(self.state, self.percentile)

    @property
    def global_tau(self) -> torch.Tensor:
        return self.taus()[-1]

    @property
    def fog_taus(self) -> torch.Tensor:
        return self.taus()[:-1]

    @property
    def seen(self) -> int:
        """Total errors observed by the global group."""
        return int(self.state.count[-1])

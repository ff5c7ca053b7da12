"""Deterministic arrival-trace generators for the serving load harness.

Underwater telemetry does not arrive back-to-back: acoustic links surface
windows of data in bursts, duty-cycled sensors report on tide/daylight
rhythms, and the IoUT serving constraint is precisely that intermittent,
bursty delivery.  These generators produce *replayable* arrival traces —
seeded, pure numpy, identical arrays for identical arguments — that
``loadgen/harness.replay`` drives against a ``ScoringService`` on a
virtual clock.

A trace is a time-sorted event stream; each event is one sensor
surfacing one telemetry window: ``(t_arrive, sensor_id, fog_id)`` plus
the per-event window row count (``rows``, constant per trace).  The
fleet-aggregate process is sampled directly and events are attributed to
sensors uniformly — the superposition of ``fleet`` independent
per-sensor Poisson processes IS the aggregate Poisson process, so this
is exact for the homogeneous-fleet model while staying O(n_events)
regardless of fleet size.

Three processes:

* :func:`poisson_trace` — constant-rate Poisson: the steady-state
  baseline.
* :func:`mmpp_trace` — a 2-state Markov-modulated Poisson process
  (on/off: exponential sojourns, per-state rates).  ``rate_off_hz=0``
  gives hard silences between bursts — the acoustic-surfacing shape that
  breaks fixed-size batching.
* :func:`diurnal_trace` — sinusoidally modulated rate via Lewis-Shedler
  thinning: slow daily load swings for autoscaling/bucket studies.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ArrivalTrace:
    """A replayable arrival trace (time-sorted, one window per event)."""

    kind: str                 # "poisson" | "mmpp" | "diurnal"
    t: np.ndarray             # (n_events,) f64 arrival seconds, sorted
    sensor: np.ndarray        # (n_events,) int32 sensor id
    fog: np.ndarray           # (n_events,) int32 fog cluster of the sensor
    rows: int                 # telemetry rows (window length) per event
    duration_s: float         # trace horizon the events were drawn over
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def n_events(self) -> int:
        return int(self.t.shape[0])

    def __len__(self) -> int:
        return self.n_events

    @property
    def total_rows(self) -> int:
        return self.n_events * self.rows

    def mean_rate_hz(self) -> float:
        """Realised event rate over the trace horizon."""
        return self.n_events / self.duration_s if self.duration_s > 0 else 0.0

    def summary(self) -> dict:
        return {
            "kind": self.kind,
            "n_events": self.n_events,
            "rows_per_event": self.rows,
            "total_rows": self.total_rows,
            "duration_s": self.duration_s,
            "mean_rate_hz": self.mean_rate_hz(),
            **self.meta,
        }


def _finish(
    kind: str,
    seed: int,
    times: np.ndarray,
    *,
    fleet: int,
    n_fog: int,
    rows: int,
    duration_s: float,
    meta: dict,
) -> ArrivalTrace:
    """Attribute aggregate arrivals to sensors (uniform, seeded) and fix
    the fog routing the repo uses everywhere (``sensor % n_fog``)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xA551]))
    times = np.asarray(times, np.float64)
    sensor = rng.integers(0, fleet, times.shape[0], dtype=np.int32)
    fog = (sensor % n_fog).astype(np.int32)
    return ArrivalTrace(
        kind=kind, t=times, sensor=sensor, fog=fog, rows=int(rows),
        duration_s=float(duration_s),
        meta={"fleet": int(fleet), "n_fog": int(n_fog), "seed": int(seed), **meta},
    )


def poisson_trace(
    seed: int,
    *,
    rate_hz: float,
    duration_s: float,
    fleet: int,
    n_fog: int,
    rows: int = 16,
) -> ArrivalTrace:
    """Constant-rate Poisson arrivals at ``rate_hz`` events/s aggregate."""
    if rate_hz <= 0 or duration_s <= 0:
        raise ValueError("rate_hz and duration_s must be positive")
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x9015]))
    # Draw in chunks until past the horizon: exact, no truncation bias.
    gaps = []
    total = 0.0
    while total < duration_s:
        chunk = rng.exponential(1.0 / rate_hz, size=max(64, int(rate_hz)))
        gaps.append(chunk)
        total += float(chunk.sum())
    times = np.cumsum(np.concatenate(gaps))
    times = times[times < duration_s]
    return _finish(
        "poisson", seed, times, fleet=fleet, n_fog=n_fog, rows=rows,
        duration_s=duration_s, meta={"rate_hz": float(rate_hz)},
    )


def mmpp_trace(
    seed: int,
    *,
    rate_on_hz: float,
    rate_off_hz: float = 0.0,
    mean_on_s: float,
    mean_off_s: float,
    duration_s: float,
    fleet: int,
    n_fog: int,
    rows: int = 16,
    start_on: bool = True,
) -> ArrivalTrace:
    """2-state on/off MMPP: exponential sojourns, Poisson within state.

    ``rate_off_hz=0`` (default) makes the off state silent — bursts of
    acoustic surfacing separated by dead air, the bursty-delivery model
    the IoUT serving literature calls out.
    """
    if rate_on_hz <= 0 or duration_s <= 0:
        raise ValueError("rate_on_hz and duration_s must be positive")
    if mean_on_s <= 0 or mean_off_s <= 0:
        raise ValueError("sojourn means must be positive")
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x3399]))
    times = []
    t, on, bursts = 0.0, bool(start_on), 0
    while t < duration_s:
        sojourn = float(rng.exponential(mean_on_s if on else mean_off_s))
        end = min(t + sojourn, duration_s)
        rate = rate_on_hz if on else rate_off_hz
        if rate > 0:
            tick = t + float(rng.exponential(1.0 / rate))
            while tick < end:
                times.append(tick)
                tick += float(rng.exponential(1.0 / rate))
        bursts += int(on)
        t, on = end, not on
    return _finish(
        "mmpp", seed, np.asarray(times), fleet=fleet, n_fog=n_fog, rows=rows,
        duration_s=duration_s,
        meta={
            "rate_on_hz": float(rate_on_hz), "rate_off_hz": float(rate_off_hz),
            "mean_on_s": float(mean_on_s), "mean_off_s": float(mean_off_s),
            "bursts": bursts,
        },
    )


def diurnal_trace(
    seed: int,
    *,
    base_rate_hz: float,
    peak_rate_hz: float,
    period_s: float,
    duration_s: float,
    fleet: int,
    n_fog: int,
    rows: int = 16,
) -> ArrivalTrace:
    """Sinusoidally modulated Poisson arrivals (Lewis-Shedler thinning).

    Instantaneous rate ``base + (peak - base) * (1 + sin(2*pi*t/T)) / 2``
    — swings between ``base_rate_hz`` and ``peak_rate_hz`` once per
    ``period_s``.
    """
    if not 0 < base_rate_hz <= peak_rate_hz or duration_s <= 0:
        raise ValueError("need 0 < base_rate_hz <= peak_rate_hz, duration > 0")
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xD1E1]))
    times = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / peak_rate_hz))
        if t >= duration_s:
            break
        rate = base_rate_hz + (peak_rate_hz - base_rate_hz) * 0.5 * (
            1.0 + np.sin(2.0 * np.pi * t / period_s)
        )
        if rng.uniform() * peak_rate_hz < rate:
            times.append(t)
    return _finish(
        "diurnal", seed, np.asarray(times), fleet=fleet, n_fog=n_fog,
        rows=rows, duration_s=duration_s,
        meta={
            "base_rate_hz": float(base_rate_hz),
            "peak_rate_hz": float(peak_rate_hz), "period_s": float(period_s),
        },
    )

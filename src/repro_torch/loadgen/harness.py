"""Open-loop replay of an arrival trace against a scoring service.

The harness drives a :class:`~repro_torch.serving.ScoringService` (or a
:class:`~repro_torch.serving.MultiTenantService`) on a VIRTUAL clock: arrival
gaps advance simulated time instantly, while every micro-batch advances
it by the batch's *measured* device wall time (the service does this via
``clock.advance``).  Replay is open-loop — arrivals never wait for the
service, exactly like real telemetry — so the recorded per-request
latency is the true end-to-end number: queue wait + batch formation
(deadline policy) + device time.  That is the quantity
``ScoringService.step`` alone cannot see and ``benchmarks/load_bench``
gates in CI.

Between arrivals the harness fires every ``max_wait_s`` deadline at its
exact virtual expiry (``next_deadline`` / ``pump``), so adaptive
micro-batching behaves as it would under a real ticking clock; a final
drain phase flushes whatever the trace left behind (for a fixed-batch
service this is where the tail pain shows up — partial batches sit until
the horizon).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

from repro_torch.loadgen.traces import ArrivalTrace


class VirtualClock:
    """Simulated seconds; the service advances it by measured device time.

    Satisfies the ``clock`` protocol of ``serving/service``: calling it
    reads the current time, ``advance`` (duck-typed) adds device seconds.
    """

    def __init__(self, t0: float = 0.0):
        self.now = float(t0)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += float(dt)

    def advance_to(self, t: float) -> None:
        """Monotonic jump — never rewinds past work already accounted."""
        self.now = max(self.now, float(t))


def gaussian_windows(
    trace: ArrivalTrace, d: int, seed: int = 0, scale: float = 1.0
) -> Callable[[int], np.ndarray]:
    """Deterministic per-event telemetry windows: event ``i`` always gets
    the same (rows, d) f32 draw, so replays are bit-replayable."""

    def window(i: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([seed, i]))
        return (scale * rng.standard_normal((trace.rows, d))).astype(np.float32)

    return window


@dataclasses.dataclass
class ReplayReport:
    """What one open-loop replay measured (see ``summary``)."""

    trace: dict                   # the trace's summary metadata
    n_events: int                 # events submitted
    completed: int                # requests fully scored
    e2e_latency_s: np.ndarray     # per completed request, submit -> result
    virtual_s: float              # simulated clock at the end of replay
    steps: int
    samples: int
    busy_s: float                 # cumulative device time
    partial_flushes: int
    compiles_by_bucket: dict[int, int]

    def _pct(self, pct: float) -> float:
        if self.e2e_latency_s.size == 0:
            return 0.0
        return float(np.percentile(self.e2e_latency_s, pct))

    def summary(self) -> dict:
        return {
            "n_events": self.n_events,
            "completed": self.completed,
            "e2e_p50_ms": self._pct(50.0) * 1e3,
            "e2e_p99_ms": self._pct(99.0) * 1e3,
            "e2e_mean_ms": (
                float(self.e2e_latency_s.mean()) * 1e3
                if self.e2e_latency_s.size else 0.0
            ),
            "e2e_max_ms": (
                float(self.e2e_latency_s.max()) * 1e3
                if self.e2e_latency_s.size else 0.0
            ),
            "virtual_s": self.virtual_s,
            "steps": self.steps,
            "samples": self.samples,
            "busy_s": self.busy_s,
            "samples_per_s": self.samples / self.busy_s if self.busy_s else 0.0,
            "mean_fill": self.samples / self.steps if self.steps else 0.0,
            "partial_flushes": self.partial_flushes,
            "compiles_by_bucket": dict(self.compiles_by_bucket),
        }


def _services(service: Any) -> list[Any]:
    """The underlying per-tenant services (or the service itself)."""
    if hasattr(service, "stats"):
        return [service]
    return [service.tenant(name) for name in service.tenants]


def _stats_totals(service: Any) -> tuple[int, int, float, int]:
    steps = samples = flushes = 0
    busy = 0.0
    for svc in _services(service):
        steps += svc.stats.steps
        samples += svc.stats.samples
        busy += svc.stats.busy_s
        flushes += svc.stats.partial_flushes
    return steps, samples, busy, flushes


def _collect_e2e(service: Any) -> np.ndarray:
    parts = [
        np.asarray(svc.stats.e2e_latency_s, np.float64)
        for svc in _services(service)
    ]
    parts = [p for p in parts if p.size]
    return np.concatenate(parts) if parts else np.zeros((0,), np.float64)


def replay(
    service: Any,
    trace: ArrivalTrace,
    clock: VirtualClock,
    *,
    windows: Callable[[int], np.ndarray] | None = None,
    d: int = 32,
    tenant_of: Callable[[int], str] | None = None,
    drain: bool = True,
) -> ReplayReport:
    """Replay ``trace`` open-loop against ``service`` on ``clock``.

    ``service`` must have been constructed with this ``clock`` (that is
    what timestamps submissions and completions).  ``windows`` maps event
    index -> (rows, d) telemetry (default :func:`gaussian_windows`);
    ``tenant_of`` maps event index -> tenant name for a
    ``MultiTenantService``.  The service should be freshly constructed —
    the report reads its cumulative stats.
    """
    windows = windows or gaussian_windows(trace, d)

    def fire_due_deadlines(horizon: float | None) -> None:
        # Flush every max_wait_s expiry strictly before `horizon` at its
        # exact virtual time (device time may push the clock past further
        # deadlines; the loop re-checks).
        while True:
            deadline = service.next_deadline()
            if deadline is None or (horizon is not None and deadline >= horizon):
                return
            clock.advance_to(deadline)
            if service.pump() == 0:
                return
    for i in range(trace.n_events):
        t_arrive = float(trace.t[i])
        fire_due_deadlines(t_arrive)
        clock.advance_to(t_arrive)
        x = windows(i)
        if tenant_of is None:
            service.submit(x, fog=int(trace.fog[i]))
        else:
            service.submit(tenant_of(i), x, fog=int(trace.fog[i]))
        service.pump()                     # full buckets flush immediately

    if drain:
        fire_due_deadlines(None)           # remaining deadline expiries
        service.drain()                    # fixed-batch leftovers flush NOW

    steps, samples, busy, flushes = _stats_totals(service)
    compiles = (
        dict(service.stats.compiles_by_bucket)
        if hasattr(service, "stats")
        else dict(service.compiles_by_bucket)
    )
    e2e = _collect_e2e(service)
    return ReplayReport(
        trace=trace.summary(),
        n_events=trace.n_events,
        completed=int(e2e.size),
        e2e_latency_s=e2e,
        virtual_s=float(clock.now),
        steps=steps,
        samples=samples,
        busy_s=busy,
        partial_flushes=flushes,
        compiles_by_bucket=compiles,
    )

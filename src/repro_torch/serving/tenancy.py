"""Multi-model tenancy: many deployments, one set of score programs.

A fleet operator serves one detector *per deployment* (per basin, per
fleet generation, per customer) — but every deployment uses the same
paper autoencoder architecture, so the score programs are shape-identical
across them.  :class:`MultiTenantService` gives each tenant its own param
double-buffer, its own ``checkpoint.CheckpointStore`` to hot-swap from,
its own thresholds and its own
:class:`~repro_torch.serving.service.ServiceStats` — while every tenant
scores through ONE shared :class:`~repro_torch.serving.service.
ScorePrograms` on one device.

Batches never mix tenants (different weights cannot share a launch);
the scheduler instead picks which tenant flushes next: any tenant with a
full largest-bucket batch first, otherwise the tenant whose oldest
request has waited longest — so one chatty tenant cannot starve a quiet
one past its ``max_wait_s`` deadline.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.serving import calibrate as cal
from repro_torch.serving.score import ScoreResult
from repro_torch.serving.service import ScorePrograms, ScoringService


class MultiTenantService:
    """Per-deployment scoring services sharing one program cache.

    Construction fixes what must be shared for the programs to be shared:
    the param template (tree/shapes), the row buckets, the weight dtype
    and the device.  ``add_tenant`` then binds a named
    deployment to its own store/threshold source.
    """

    def __init__(
        self,
        params_like: Any,
        *,
        batch_rows: int = 1024,
        buckets: tuple[int, ...] | None = None,
        max_wait_s: float | None = None,
        weight_dtype: str = "f32",
        clock: Callable[[], float] = time.monotonic,
        device: torch.device | str | None = None,
    ):
        self.buckets = tuple(sorted(set(buckets or (int(batch_rows),))))
        self.max_wait_s = max_wait_s
        self._params_like = params_like
        self._clock = clock
        self.programs = ScorePrograms(weight_dtype=weight_dtype, device=device)
        self._tenants: dict[str, ScoringService] = {}

    # ------------------------------------------------------------------
    # tenant management
    # ------------------------------------------------------------------

    def add_tenant(
        self,
        name: str,
        store: CheckpointStore,
        *,
        tau: float | None = None,
        calibrator: cal.StreamingCalibrator | None = None,
        poll_every: int = 1,
        poll_interval_s: float | None = None,
    ) -> ScoringService:
        """Register a deployment; its latest published round loads now.
        Returns the tenant's service (submit/poll also work through the
        multi-tenant front door)."""
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already registered")
        svc = ScoringService(
            store, self._params_like,
            buckets=self.buckets, max_wait_s=self.max_wait_s,
            tau=tau, calibrator=calibrator,
            poll_every=poll_every, poll_interval_s=poll_interval_s,
            weight_dtype=self.programs.weight_dtype, clock=self._clock,
            programs=self.programs,
        )
        self._tenants[name] = svc
        return svc

    def tenant(self, name: str) -> ScoringService:
        return self._tenants[name]

    @property
    def tenants(self) -> tuple[str, ...]:
        return tuple(self._tenants)

    @property
    def compiles_by_bucket(self) -> dict[int, int]:
        """Shared per-bucket program counts — one per bucket, total, no
        matter how many tenants score through it."""
        return dict(self.programs.compiles)

    # ------------------------------------------------------------------
    # request flow
    # ------------------------------------------------------------------

    def submit(
        self, tenant: str, x: Any, fog: int | None = None
    ) -> tuple[str, int]:
        """Queue telemetry for one deployment; the (tenant, rid) pair is
        the key :func:`drain` delivers the result under."""
        return tenant, self._tenants[tenant].submit(x, fog)

    def pending_rows(self) -> int:
        return sum(s.pending_rows() for s in self._tenants.values())

    def next_deadline(self) -> float | None:
        deadlines = [
            d for s in self._tenants.values()
            if (d := s.next_deadline()) is not None
        ]
        return min(deadlines) if deadlines else None

    def should_flush(self, now: float | None = None) -> bool:
        return any(s.should_flush(now) for s in self._tenants.values())

    def _next_tenant(self, now: float | None) -> ScoringService | None:
        """Full batches first (throughput), then the tenant whose oldest
        request has waited longest (fairness under deadlines)."""
        ready = [s for s in self._tenants.values() if s.should_flush(now)]
        if not ready:
            return None
        full = [s for s in ready if s.pending_rows() >= s.buckets[-1]]
        if full:
            return full[0]
        return max(ready, key=lambda s: s.oldest_wait_s(now))

    def step(self, now: float | None = None) -> int:
        """Flush ONE tenant's micro-batch (scheduler above); 0 when no
        tenant is due."""
        svc = self._next_tenant(now)
        return 0 if svc is None else svc.step()

    def pump(self, now: float | None = None) -> int:
        total = 0
        while self.should_flush(now):
            total += self.step(now)
        return total

    def tick(self, now: float | None = None) -> int:
        """Idle heartbeat: per-tenant wall-clock checkpoint polls plus any
        due deadline flushes."""
        for svc in self._tenants.values():
            svc.tick(now)
        return self.pump(now)

    def drain(self) -> dict[tuple[str, int], ScoreResult]:
        """Force-flush every tenant; results keyed by (tenant, rid)."""
        out: dict[tuple[str, int], ScoreResult] = {}
        for name, svc in self._tenants.items():
            for rid, res in svc.drain().items():
                out[(name, rid)] = res
        return out

    def poll(self) -> dict[str, bool]:
        """Hot-swap every tenant to its own newest published round."""
        return {name: svc.poll() for name, svc in self._tenants.items()}

    def summary(self) -> dict:
        tenants = {name: svc.stats.summary() for name, svc in self._tenants.items()}
        return {
            "tenants": tenants,
            "compiles_by_bucket": self.compiles_by_bucket,
            "compiles": sum(self.programs.compiles.values()),
            "requests": sum(t["requests"] for t in tenants.values()),
            "samples": sum(t["samples"] for t in tenants.values()),
            "steps": sum(t["steps"] for t in tenants.values()),
        }

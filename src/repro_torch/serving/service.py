"""Micro-batching anomaly-scoring service with train-and-serve hot-swap.

One :class:`ScoringService` turns the trained detector into an online
scorer: telemetry requests queue up, get packed into FIXED-SHAPE
micro-batches, and are scored with the fused kernel path
(``serving/score``), one kernel launch per micro-batch.  The padded batch
shapes come from a small set of row *buckets* (e.g. 128/1024): every
micro-batch picks the smallest bucket that covers the queue depth, so
light traffic stops paying the full-batch padding tax.

Batch formation is deadline-driven when ``max_wait_s`` is set: a partial
batch is flushed as soon as the OLDEST queued request has waited that
long, instead of holding telemetry hostage until ``batch_rows`` fill up.
``should_flush``/``pump``/``tick`` expose that policy to open-loop
replay (``repro_torch.loadgen.harness``); ``drain`` still force-flushes.

Hot-swap: the service watches a ``checkpoint.CheckpointStore`` that the
trainer publishes rounds into.  Parameters are double-buffered — ``poll()``
restores a newer round into the standby buffer (same tree and shapes as
the active one) and flips the active pointer between micro-batches.  Saves
are atomic (tmp + ``os.replace``), so a poll can never observe a
half-written round.  Polling runs every ``poll_every`` scoring steps AND
— so an idle service still swaps — every ``poll_interval_s`` seconds of
clock time, checked from ``submit``/``step``/``tick``.

Serving weights are f32 by default; ``weight_dtype="int8"`` keeps the
double-buffered params as per-output-channel symmetric int8
(``serving/score.quantize_params``), dequantised inside the fused kernel.

The ``clock`` is injectable (anything callable returning seconds; an
object with ``advance(dt)`` is advanced by the measured step time, which
ends with the device-to-host copy of the results and so includes the
device time).  Production uses ``time.monotonic``; the load harness drives
a virtual clock so queueing delay is simulated while device time stays
real.

Thresholds come from a fixed global tau (Eq. 32), or live from a
``serving/calibrate.StreamingCalibrator`` fed by ``ingest_validation`` —
per-fog when requests carry a fog id, global otherwise.

The service runs on the Hopper card unless ``device="cpu"`` is given
(the plain PyTorch path); with no card it raises.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.checkpoint import CheckpointStore
from repro_torch.serving import calibrate as cal
# Import the functions, not the submodule: the package __init__ re-exports
# a function named `score`, which shadows the module attribute.
from repro_torch.serving.score import ScoreResult, quantize_params
from repro_torch.serving.score import score as _score
from repro_torch.serving.score import score_q8 as _score_q8


class ScorePrograms:
    """The score programs, one per row bucket — shareable.

    Several services (the tenants of a
    :class:`repro_torch.serving.tenancy.MultiTenantService`) score through
    the SAME programs and device.  ``compiles`` maps bucket -> 1 from the
    bucket's first use on: PyTorch has nothing to trace, and the kernel is
    built once per process, but the count keeps the JAX package's report
    shape (one program per bucket).
    """

    def __init__(
        self,
        *,
        weight_dtype: str = "f32",
        device: torch.device | str | None = None,
    ):
        if weight_dtype not in ("f32", "int8"):
            raise ValueError(f"weight_dtype must be f32|int8, got {weight_dtype!r}")
        self.weight_dtype = weight_dtype
        self.device = _device.resolve(device)
        self.compiles: dict[int, int] = {}
        self._fns: dict[int, Callable] = {}

    def prepare(self, params: Any) -> Any:
        """Convert a restored f32 param tree to the serving representation
        on this device."""
        f32 = [
            {k: torch.as_tensor(v).to(self.device, torch.float32).contiguous()
             for k, v in layer.items()}
            for layer in params
        ]
        return quantize_params(f32) if self.weight_dtype == "int8" else f32

    def fn(self, bucket: int) -> Callable:
        if bucket not in self._fns:
            compiles = self.compiles
            score_fn = _score_q8 if self.weight_dtype == "int8" else _score

            def run(p, x, t):
                compiles.setdefault(bucket, 1)
                return score_fn(p, x, t)

            self._fns[bucket] = run
        return self._fns[bucket]


@dataclasses.dataclass
class ServiceStats:
    requests: int = 0
    samples: int = 0          # real (unpadded) telemetry rows scored
    steps: int = 0            # micro-batches executed
    swaps: int = 0            # hot-swaps applied after the initial load
    partial_flushes: int = 0  # batches flushed below the chosen bucket fill
    dropped: int = 0          # submissions rejected by the max_queue cap
    psi: float = 0.0          # calibration drift signal (last ingest)
    busy_s: float = 0.0       # cumulative scoring wall time (all steps)
    # First-use counts per row bucket — shared with (and written by) the
    # ScorePrograms, so under multi-tenancy every tenant sees the same
    # per-bucket counts.
    compiles_by_bucket: dict[int, int] = dataclasses.field(default_factory=dict)
    # Bounded windows so an indefinitely-running service does not grow
    # per-step history without bound; percentiles are over these windows.
    step_latency_s: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=4096)
    )
    # True per-request latency: submit timestamp -> result completion,
    # i.e. queue wait + batch formation + device time.
    e2e_latency_s: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=1 << 17)
    )

    @property
    def compiles(self) -> int:
        """Total programs across all buckets."""
        return sum(self.compiles_by_bucket.values())

    def _pct(self, window, pct: float) -> float:
        if not window:
            return 0.0
        return float(np.percentile(np.asarray(window), pct))

    def step_latency(self, pct: float) -> float:
        """Percentile of the per-micro-batch step latency (host to device,
        kernel, device to host; recent window) — not what a request
        experiences."""
        return self._pct(self.step_latency_s, pct)

    def e2e_latency(self, pct: float) -> float:
        """Percentile of the per-request end-to-end latency."""
        return self._pct(self.e2e_latency_s, pct)

    def samples_per_s(self) -> float:
        return self.samples / self.busy_s if self.busy_s > 0 else 0.0

    def summary(self) -> dict:
        return {
            "requests": self.requests,
            "samples": self.samples,
            "steps": self.steps,
            "swaps": self.swaps,
            "compiles": self.compiles,
            "compiles_by_bucket": dict(self.compiles_by_bucket),
            "partial_flushes": self.partial_flushes,
            "step_p50_ms": self.step_latency(50.0) * 1e3,
            "step_p99_ms": self.step_latency(99.0) * 1e3,
            "e2e_p50_ms": self.e2e_latency(50.0) * 1e3,
            "e2e_p99_ms": self.e2e_latency(99.0) * 1e3,
            "samples_per_s": self.samples_per_s(),
            "dropped": self.dropped,
            "psi": self.psi,
        }


class _Request:
    __slots__ = (
        "rid", "rows", "fog", "lead", "t_submit", "parts_err", "parts_flag",
        "taken",
    )

    def __init__(self, rid, rows, fog, lead, t_submit):
        self.rid = rid
        self.rows = rows          # (n, d) f32 numpy
        self.fog = fog            # int fog id or None
        self.lead = lead          # original leading shape to restore
        self.t_submit = t_submit  # clock time at submit (e2e latency base)
        self.parts_err: list[np.ndarray] = []
        self.parts_flag: list[np.ndarray] = []
        self.taken = 0            # rows already scheduled


class ScoringService:
    """Online scorer over a checkpoint store (see module docstring).

    ``params_like``: a template param tree (e.g. ``autoencoder.init``
    output) fixing the tree and shapes every published round must match —
    the double-buffer swap relies on it.

    ``buckets`` (default ``(batch_rows,)``) are the padded micro-batch row
    shapes; ``max_wait_s=None`` keeps the flush-when-asked semantics, a
    float makes ``pump``/``tick`` flush partial batches once the oldest
    request has waited that long.  ``programs`` injects a shared
    :class:`ScorePrograms` (multi-tenancy); by default the service owns
    one on ``device`` (``None``: the Hopper card).
    """

    def __init__(
        self,
        store: CheckpointStore,
        params_like: Any,
        *,
        batch_rows: int = 1024,
        buckets: tuple[int, ...] | None = None,
        tau: float | None = None,
        calibrator: cal.StreamingCalibrator | None = None,
        poll_every: int = 1,
        poll_interval_s: float | None = None,
        max_wait_s: float | None = None,
        max_queue: int | None = None,
        weight_dtype: str = "f32",
        clock: Callable[[], float] = time.monotonic,
        programs: ScorePrograms | None = None,
        device: torch.device | str | None = None,
    ):
        if (tau is None) and (calibrator is None):
            raise ValueError("need a fixed tau or a StreamingCalibrator")
        self.store = store
        self.buckets = tuple(sorted(set(buckets or (int(batch_rows),))))
        if any(b <= 0 for b in self.buckets):
            raise ValueError(f"buckets must be positive, got {self.buckets}")
        self.batch_rows = self.buckets[-1]
        self.tau = None if tau is None else float(tau)
        self.calibrator = calibrator
        self.poll_every = max(1, int(poll_every))
        self.poll_interval_s = (
            None if poll_interval_s is None else float(poll_interval_s)
        )
        self.max_wait_s = None if max_wait_s is None else float(max_wait_s)
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = None if max_queue is None else int(max_queue)
        self._clock = clock
        if programs is None:
            programs = ScorePrograms(weight_dtype=weight_dtype, device=device)
        elif programs.weight_dtype != weight_dtype:
            raise ValueError(
                f"shared programs serve {programs.weight_dtype} weights, "
                f"service asked for {weight_dtype}"
            )
        elif device is not None and torch.device(device) != programs.device:
            raise ValueError(
                f"shared programs run on {programs.device}, service asked for {device}"
            )
        self.programs = programs
        self.device = programs.device
        self.stats = ServiceStats(compiles_by_bucket=programs.compiles)
        # deque: batch formation pops the head per request; a plain list's
        # pop(0) is O(n), i.e. quadratic in queue depth under sustained
        # load.
        self._queue: collections.deque[_Request] = collections.deque()
        self._pending_rows = 0
        self._done: dict[int, ScoreResult] = {}
        self._next_rid = 0
        self._last_poll_t = self._clock()

        self._like = params_like
        params, step = store.restore(params_like)
        # Double buffer: every hot-swap prepares the restored round into
        # the standby slot and flips the pointer.
        self._buffers = [programs.prepare(params), programs.prepare(params)]
        self._active = 0
        self._loaded_step = step
        self.d = int(params_like[0]["w"].shape[0])

    # ------------------------------------------------------------------
    # checkpoint watching / hot-swap
    # ------------------------------------------------------------------

    @property
    def params(self) -> Any:
        return self._buffers[self._active]

    @property
    def loaded_step(self) -> int:
        return self._loaded_step

    def poll(self) -> bool:
        """Hot-swap to the newest published round, if any.  Returns True
        when a swap happened.  Same-tree restore, prepared (f32 or
        int8-quantised) into the standby buffer + pointer flip: no torn
        reads (saves are atomic).  A concurrent trainer's retention pass
        may delete the step between ``latest_step`` and the read — treat
        that as "nothing new" and pick the fresher round up on the next
        poll."""
        self._last_poll_t = self._clock()
        step = self.store.latest_step()
        if step is None or step == self._loaded_step:
            return False
        standby = 1 - self._active
        try:
            raw, step = self.store.restore(self._like, step=step)
        except FileNotFoundError:
            return False
        self._buffers[standby] = self.programs.prepare(raw)
        self._loaded_step = step
        self._active = standby
        self.stats.swaps += 1
        return True

    def _maybe_poll(self, now: float) -> bool:
        """Wall-clock polling path: swap even when no batches run."""
        if (
            self.poll_interval_s is not None
            and now - self._last_poll_t >= self.poll_interval_s
        ):
            return self.poll()
        return False

    # ------------------------------------------------------------------
    # request queue / micro-batching
    # ------------------------------------------------------------------

    def submit(self, x: Any, fog: int | None = None) -> int | None:
        """Queue telemetry of shape (..., d); returns a request id whose
        result :func:`drain` delivers with the leading shape restored.

        With ``max_queue`` set, submissions arriving while that many
        requests are already queued are REJECTED — admission control, so
        sustained overload sheds load at the door instead of growing the
        queue without bound.  A rejected submit returns ``None`` and bumps
        ``stats.dropped``; nothing else changes.
        """
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        arr = np.asarray(x, np.float32)
        if arr.shape[-1] != self.d:
            raise ValueError(f"expected feature dim {self.d}, got {arr.shape}")
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            self.stats.dropped += 1
            return None
        lead = arr.shape[:-1]
        rid = self._next_rid
        self._next_rid += 1
        now = self._clock()
        req = _Request(rid, arr.reshape(-1, self.d), fog, lead, now)
        self._queue.append(req)
        self._pending_rows += req.rows.shape[0]
        self.stats.requests += 1
        self._maybe_poll(now)
        return rid

    def pending_rows(self) -> int:
        """Telemetry rows queued but not yet scheduled into a batch."""
        return self._pending_rows

    def oldest_wait_s(self, now: float | None = None) -> float:
        """How long the oldest queued request has been waiting."""
        if not self._queue:
            return 0.0
        now = self._clock() if now is None else now
        return now - self._queue[0].t_submit

    def next_deadline(self) -> float | None:
        """Clock time at which the oldest queued request's ``max_wait_s``
        expires (None when idle or when deadlines are disabled)."""
        if self.max_wait_s is None or not self._queue:
            return None
        return self._queue[0].t_submit + self.max_wait_s

    def should_flush(self, now: float | None = None) -> bool:
        """Flush policy: a full largest-bucket batch is ready, or the
        oldest queued request has exceeded its ``max_wait_s`` deadline."""
        if self._pending_rows <= 0:
            return False
        if self._pending_rows >= self.buckets[-1]:
            return True
        if self.max_wait_s is None:
            return False
        return self.oldest_wait_s(now) >= self.max_wait_s

    def _pick_bucket(self) -> int:
        """Smallest bucket covering the queue depth (largest when the
        queue exceeds every bucket)."""
        for b in self.buckets:
            if b >= self._pending_rows:
                return b
        return self.buckets[-1]

    def _taus(self) -> np.ndarray | None:
        """Current (n_fog + 1) thresholds, resolved ONCE per micro-batch —
        the reservoir percentile must not run per request on the hot
        path."""
        if self.calibrator is None:
            return None
        return self.calibrator.taus().numpy()

    def _row_tau(self, req: _Request, taus: np.ndarray | None) -> float:
        if taus is not None:
            return float(taus[req.fog]) if req.fog is not None else float(taus[-1])
        return self.tau

    def _run(self, bucket: int, batch: np.ndarray, tau: np.ndarray):
        """One micro-batch on the device; returns host (err, flag) and the
        step time.  The device-to-host copy of the results is the
        synchronisation point, so the time includes the kernel."""
        fn = self.programs.fn(bucket)
        t0 = time.perf_counter()
        res = fn(
            self.params,
            torch.from_numpy(batch).to(self.device),
            torch.from_numpy(tau).to(self.device),
        )
        err, flag = res.error.cpu().numpy(), res.flag.cpu().numpy()
        return err, flag, time.perf_counter() - t0

    def step(self) -> int:
        """Score ONE padded micro-batch off the queue; returns the number
        of real rows scored (0 when idle)."""
        if not self._queue:
            return 0
        taus = self._taus()
        bucket = self._pick_bucket()
        batch = np.zeros((bucket, self.d), np.float32)
        tau = np.full((bucket,), np.inf, np.float32)
        taken: list[tuple[_Request, int, int]] = []  # req, start, n
        fill = 0
        while self._queue and fill < bucket:
            req = self._queue[0]
            n = min(req.rows.shape[0] - req.taken, bucket - fill)
            batch[fill : fill + n] = req.rows[req.taken : req.taken + n]
            tau[fill : fill + n] = self._row_tau(req, taus)
            taken.append((req, fill, n))
            req.taken += n
            fill += n
            if req.taken == req.rows.shape[0]:
                self._queue.popleft()
        self._pending_rows -= fill
        if fill < bucket:
            self.stats.partial_flushes += 1

        err, flag, lat = self._run(bucket, batch, tau)
        # A virtual clock (load replay) advances by the measured step
        # time, so completion timestamps — and therefore e2e latency —
        # include it on both the real and the simulated clock.
        advance = getattr(self._clock, "advance", None)
        if advance is not None:
            advance(lat)
        t_done = self._clock()

        for req, start, n in taken:
            req.parts_err.append(err[start : start + n])
            req.parts_flag.append(flag[start : start + n])
            if req.taken == req.rows.shape[0] and sum(
                p.shape[0] for p in req.parts_err
            ) == req.rows.shape[0]:
                self._done[req.rid] = ScoreResult(
                    np.concatenate(req.parts_err).reshape(req.lead),
                    np.concatenate(req.parts_flag).reshape(req.lead),
                )
                self.stats.e2e_latency_s.append(t_done - req.t_submit)
        self.stats.steps += 1
        self.stats.samples += fill
        self.stats.step_latency_s.append(lat)
        self.stats.busy_s += lat
        if self.stats.steps % self.poll_every == 0:
            self.poll()
        else:
            self._maybe_poll(t_done)
        return fill

    def pump(self, now: float | None = None) -> int:
        """Run micro-batches while the flush policy says so (full largest
        bucket, or expired ``max_wait_s`` deadline); returns rows scored."""
        total = 0
        while self.should_flush(now):
            total += self.step()
        return total

    def tick(self, now: float | None = None) -> int:
        """Idle heartbeat: wall-clock checkpoint poll + deadline flushes.
        Call this from a serving loop when no requests are arriving."""
        self._maybe_poll(self._clock() if now is None else now)
        return self.pump(now)

    def drain(self) -> dict[int, ScoreResult]:
        """Run micro-batches until the queue is empty; hand back (and
        clear) every completed request's :class:`ScoreResult`."""
        while self._queue:
            self.step()
        done, self._done = self._done, {}
        return done

    # ------------------------------------------------------------------
    # streaming calibration feed
    # ------------------------------------------------------------------

    def ingest_validation(self, x: Any, fog_id: Any | None = None) -> torch.Tensor:
        """Score a normal-only validation batch through the SAME program
        (largest bucket, tau=+inf, flags discarded) and feed the errors to
        the calibrator.  ``fog_id`` must broadcast to ``x.shape[:-1]``
        (e.g. a (fleet, 1) column for (fleet, window, d) telemetry).
        Returns the errors, flattened, as a CPU tensor."""
        if self.calibrator is None:
            raise ValueError("service was built without a calibrator")
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.asarray(x, np.float32)
        fid = None
        if fog_id is not None:
            fid = np.broadcast_to(np.asarray(fog_id, np.int64), x.shape[:-1]).reshape(-1)
        arr = x.reshape(-1, self.d)
        rows = self.batch_rows
        errs = []
        for start in range(0, arr.shape[0], rows):
            chunk = arr[start : start + rows]
            batch = np.zeros((rows, self.d), np.float32)
            batch[: chunk.shape[0]] = chunk
            tau = np.full((rows,), np.inf, np.float32)
            err, _, _ = self._run(rows, batch, tau)
            errs.append(err[: chunk.shape[0]])
        err = torch.from_numpy(np.concatenate(errs))
        self.calibrator.observe(err, fid)
        # Surface the calibrator's drift signal where operators look.
        self.stats.psi = self.calibrator.psi()
        return err

"""Batched multi-deployment simulation engine.

One :class:`Engine` call evaluates a whole ablation cell — every seed and
deployment realisation of one configuration — as ONE batched round loop,
instead of running ``hfl.train`` / ``flat_fl.train_flat`` once per seed
the way the sequential path (``experiment.seed_sweep``) does.

Batch axes
----------
``Engine.run`` / ``Engine.audit`` take ``seeds`` (length S) and
``n_deployments`` (P) and build an (S, P) grid of trial seeds
(:meth:`Engine._trial_keys`):

* trial ``(s, 0)`` draws its inputs from ``torch.Generator().manual_seed(
  seeds[s])`` through ``experiment.draw_trial`` — what a sequential
  ``experiment.run_method(..., seed=seeds[s])`` draws, which the
  equivalence tests in ``tests/test_torch_engine.py`` pin down;
* trial ``(s, j > 0)`` draws the next trial from the same generator,
  after column j - 1's draws: an independent deployment realisation (and
  model init) per column.  (A derived seed such as ``s + (j << 32)`` would
  not do: the CPU generator reads only the low 32 bits of a seed.)

The B = S * P trials run through ``experiment.batched_trial_metrics``: the
round's physics carries a leading trial axis, and the trials fold into the
kernels' own axes, B * N clients for ``local_train_f32`` (each trial's own
start vector) and B * M fogs for ``fused_agg`` / the wire pair /
``robust_agg`` (trial b's fog ids offset by b * M).  So a round of the
whole grid makes one trial's kernel launches, and the host's dispatch
cost per round is paid once for the B trials.  That holds for the
unchunked route (``local_train_f32``, ``fused_agg``, ``robust_agg``): with
``client_chunk`` set, the wire pair walks the B * N folded clients a chunk
at a time, so ``wire_emit`` and ``wire_agg`` launch ceil(B * N / chunk)
times a round, about B times one trial's.  Each call's log entry
carries those launches (:meth:`Engine.take_log`), the port's counterpart
of the reference's compile counts.  SCAFFOLD and the centralised oracle
run no kernel; their trials run one after another (``batched: false`` in
the log).  The async family (``hfl-async``, ``core/async_fl``) folds its
trials the same way, an event for a round: one ``local_train_f32``, one
``fused_agg`` and, with a robust reduce, one ``robust_agg`` call an event
for the whole cell.  Results come back with leading (S, P) axes.

Config sweeps
-------------
``Engine.sweep`` groups a config grid into shape classes, as the
reference's engine does on its kernel backend: cells whose configs differ
only in the reference's swept leaves (the channel and energy physics,
``server_lr``, ``compute_rate_flops``, the fault probabilities, the drift
rates, the async knobs, a global compressor's ``rho_s``) share a class,
unless they differ in a knob the kernels take as a scalar (``rho_s`` of a
blockwise compressor, ``lr`` / ``prox_mu`` of the fused local solver,
``trim_frac`` of a robust reduce).  A class of C cells is ONE
``batched_trial_metrics`` (or ``audit_trials``) call over B = C * S * P
trials: trial (c, s, j) draws what ``Engine.run(cfgs[c], ...)`` draws for
(s, j), and each knob the cells differ in becomes a (B,) f32 tensor of
per-trial values (:func:`_fold`), so a class launches each kernel as
often as one of its cells.

Compressor default
------------------
Unless constructed with ``compressor="keep"``, the engine rewrites sparse
(``rho_s < 1``) int8 or f32 ``mode="global"`` compressor configs to the
blockwise kernel path, as the reference's engine does.  The port's
compressor has no backend flags (the tensor's device picks the kernel or
its plain version), so that is the whole rewrite, and the local solver
resolves to itself.  ``Engine.resolve_config`` exposes the rewrite so
sequential comparisons can run the identical numerics.

Devices
-------
Entry points run on the card (``device=None``: the current CUDA device)
unless the engine is built with ``device="cpu"``.  Without an initialised
``torch.distributed`` process group the engine runs on that one device,
however many are visible.  Under a group of W > 1 ranks (one process per
card, ``torchrun``; every rank makes the same calls):

* ``shard_clients=True`` slices a ``run`` cell's client axis over the
  ranks (``launch/sharding.ClientMesh``, ``core/hfl``'s client mesh) when
  the method is a hierarchical or flat round (not ``centralised``,
  ``scaffold`` or ``hfl-async``) and W divides the sensor count; the log
  entry says ``client_sharded``;
* otherwise ``shard_trials=True`` (the default) gives rank r the seeds
  ``[r * S / W, (r + 1) * S / W)`` of a ``run`` or ``sweep`` cell with all
  P deployments of each, so every trial draws what it draws unsharded,
  and every rank then assembles the whole result by a zero-filled
  ``all_reduce``; it applies when W divides S, and the log entry says
  ``trial_sharded``.  Otherwise every rank runs every trial.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import itertools
import time
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch import device as _device
from repro_torch.core import aggregation as agg
from repro_torch.core import async_fl
from repro_torch.core import channel as ch
from repro_torch.core import compression as comp
from repro_torch.core import drift as drf
from repro_torch.core import energy as en
from repro_torch.core import faults as flt
from repro_torch.core import hfl
from repro_torch.core import participation as part
from repro_torch.core import topology as topo
from repro_torch.data.synthetic import SensorDataset
from repro_torch.kernels import fused_agg, fused_score, local_train, quant8, robust_agg, topk_ef
from repro_torch.launch import experiment as exp
from repro_torch.launch import sharding
from repro_torch.optim.sgd import LocalTrainConfig

# Methods that run whole on every rank: no client mesh, as in the reference.
UNSHARDED = ("centralised", "scaffold", "hfl-async")

_COUNTERS = (local_train, fused_agg, robust_agg, quant8, topk_ef, fused_score)


def _launches() -> dict[str, int]:
    """Every training and scoring kernel's launch count so far."""
    return {k: v for mod in _COUNTERS for k, v in mod.LAUNCHES.items()}


def _describe_compressor(cc: comp.CompressorConfig, dev: torch.device) -> str:
    """Short tag recorded per cell: which numerics ran (the engine may
    rewrite ``global`` configs) and where (the kernel or its plain
    version)."""
    if not cc.enabled:
        return "dense"
    backend = ("cuda" if dev.type == "cuda" else "plain") if cc.mode == "blockwise" else "torch"
    return f"{cc.mode}[{backend}] rho={cc.rho_s:g} q{cc.quant_bits}"


def _base_cfg(cfg: Any) -> hfl.HFLConfig:
    """The round-loop config of an async config, else the config itself."""
    return cfg.base if isinstance(cfg, async_fl.AsyncFLConfig) else cfg


def _map_leaves(x: Any, leaf: Callable[[Any], Any]) -> Any:
    """A config as nested tuples of (field, value), ``leaf`` applied to
    every value that is not a dataclass or a tuple."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            (f.name, _map_leaves(getattr(x, f.name), leaf)) for f in dataclasses.fields(x))
    if isinstance(x, tuple):
        return tuple(_map_leaves(v, leaf) for v in x)
    return leaf(x)


def _tensor_key(x: torch.Tensor, content: bool) -> tuple:
    t = x.detach().to("cpu", torch.float32).contiguous()
    shape = ("tensor", tuple(t.shape))
    return shape + (hashlib.sha1(t.numpy().tobytes()).hexdigest(),) if content else shape


def _cfg_key(x: Any) -> Any:
    """A config as a hashable cache key: a tensor leaf by its shape and
    its bytes, never by the tensor object."""
    return _map_leaves(x, lambda v: _tensor_key(v, True) if isinstance(v, torch.Tensor) else v)


# The reference's pytree leaves (``repro/core/hfl.py`` ``_HFL_LEAF_FIELDS``,
# ``faults.py``, ``drift.py``, ``async_fl.py``, ``compression.py``, and every
# ``ChannelParams`` / ``EnergyParams`` field): a number there is a knob that
# a sweep's cells may differ in and still share a class, one value per
# trial.  Every other field is static (the reference's aux data), and so
# are ``sparse`` / ``active``, which enter as the derived predicates below.
_ALL = "all"
_KNOBS: dict[type, Any] = {
    hfl.HFLConfig: ("lr", "prox_mu", "server_lr", "compute_rate_flops", "compressor", "channel",
                    "energy", "trim_frac", "faults", "drift"),
    comp.CompressorConfig: ("rho_s",),
    ch.ChannelParams: _ALL,
    en.EnergyParams: _ALL,
    flt.FaultConfig: ("erasure_prob", "crash_prob", "byz_frac", "byz_scale"),
    drf.DriftConfig: ("sensor_current_m_s", "reassoc_every", "covariate_shift"),
    async_fl.AsyncFLConfig: ("base", "buffer_k", "fog_k", "alpha", "timeout_s", "fog_timeout_s",
                             "tau_max", "arrival_delay_s"),
}
_DERIVED: dict[type, tuple[str, str]] = {   # (pinned field, the static predicate it pins)
    comp.CompressorConfig: ("sparse", "is_sparse"),
    flt.FaultConfig: ("active", "is_active"),
    drf.DriftConfig: ("active", "is_active"),
}


def _is_knob(x: Any, name: str) -> bool:
    knobs = _KNOBS.get(type(x), ())
    return knobs == _ALL or name in knobs


def _signature(x: Any) -> Any:
    """A config's shape-class signature, the reference's leaf / aux split:
    a number in a knob field blanked, a tensor knob (a replayed
    ``arrival_delay_s``) kept as its shape, every static field kept
    (enums, counts, modes, flags, the deployment), and the derived
    ``is_sparse`` / ``is_active`` predicates in place of their pins."""
    pinned, derived = _DERIVED.get(type(x), (None, None))
    parts: list[Any] = [type(x).__name__]
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        if f.name == pinned:
            continue
        if not _is_knob(x, f.name):
            parts.append((f.name, _cfg_key(v)))
        elif dataclasses.is_dataclass(v):
            parts.append((f.name, _signature(v)))
        elif isinstance(v, torch.Tensor):
            parts.append((f.name, _tensor_key(v, False)))
        else:
            parts.append((f.name, None))
    if derived is not None:
        parts.append((derived, getattr(x, derived)))
    return tuple(parts)


def _static_knobs(cfg: Any) -> tuple:
    """Knobs a class must share although they are the reference's leaves:
    what the port's kernels take as scalars (the reference's
    ``Engine._kernel_static_knobs`` for a kernel-backed config, on every
    device: the plain versions take the same scalars) — ``rho_s`` of a
    sparse blockwise compressor (``fused_agg``, the wire pair,
    ``compress_q8``, ``topk_ef``), ``lr`` and ``prox_mu`` of the fused
    local solver (``local_train_f32``), ``trim_frac`` of a robust reduce
    (``robust_agg``) — and a number ``arrival_delay_s``, which the async
    event tells from a replayed (N,) clock by its rank."""
    base = _base_cfg(cfg)
    knobs: dict[str, float] = {}
    cc = base.compressor
    if cc.enabled and cc.is_sparse and cc.mode == "blockwise":
        knobs["rho_s"] = float(cc.rho_s)
    if base.local_solver.fused:
        knobs["lr"] = float(base.lr)
        knobs["prox_mu"] = float(base.prox_mu)
    if base.robust != "mean":
        knobs["trim_frac"] = float(base.trim_frac)
    if isinstance(cfg, async_fl.AsyncFLConfig) and not isinstance(cfg.arrival_delay_s,
                                                                  torch.Tensor):
        knobs["arrival_delay_s"] = float(cfg.arrival_delay_s)
    return tuple(sorted(knobs.items()))


def _knob_leaves(x: Any, path: str = "") -> dict[str, Any]:
    """Every knob leaf of a config (:data:`_KNOBS`) by its dotted path."""
    out: dict[str, Any] = {}
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        if not _is_knob(x, f.name):
            continue
        if dataclasses.is_dataclass(v):
            out.update(_knob_leaves(v, f"{path}{f.name}."))
        else:
            out[f"{path}{f.name}"] = v
    return out


def _same(vals: Sequence[Any]) -> bool:
    if isinstance(vals[0], torch.Tensor):
        return all(_tensor_key(v, True) == _tensor_key(vals[0], True) for v in vals)
    return all(v == vals[0] for v in vals)


def _fold(cells: Sequence[Any], reps: int) -> tuple[Any, list[str]]:
    """A class's C cells as one config of B = C * reps trials (cell c's
    trials are rows c * reps .. (c + 1) * reps - 1): each knob the cells
    differ in becomes a (B,) f32 CPU tensor of per-trial values (a
    replayed (N,) ``arrival_delay_s`` a (B, N) one), every other field is
    the first cell's, so a knob all cells share keeps its number and its
    arithmetic.  A nested config that takes tensors has its predicate
    pinned (``sparse`` / ``active``).  Returns (config, swept paths)."""
    rep, changes, swept = cells[0], {}, []
    for f in dataclasses.fields(rep):
        if not _is_knob(rep, f.name):
            continue
        vals = [getattr(c, f.name) for c in cells]
        if dataclasses.is_dataclass(vals[0]):
            sub, paths = _fold(vals, reps)
            if paths:
                changes[f.name] = sub
                swept += [f"{f.name}.{p}" for p in paths]
        elif not _same(vals):
            if isinstance(vals[0], torch.Tensor):
                t = torch.stack([v.detach().to("cpu", torch.float32) for v in vals])
            else:
                t = torch.tensor([float(v) for v in vals], dtype=torch.float32)
            changes[f.name] = t.repeat_interleave(reps, dim=0)
            swept.append(f.name)
    if not changes:
        return rep, []
    pinned, derived = _DERIVED.get(type(rep), (None, None))
    if pinned is not None:
        changes[pinned] = getattr(rep, derived)
    return dataclasses.replace(rep, **changes), swept


def _grid(out: dict[str, Any], *lead: int) -> dict[str, Any]:
    """Leading B axis -> ``lead`` ((S, P), or (C, S, P) for a sweep
    class); ``params`` layers alike."""
    def split(t):
        return t.reshape(lead + tuple(t.shape[1:]))

    return {k: [{n: split(t) for n, t in layer.items()} for layer in v] if k == "params"
            else split(v) for k, v in out.items()}


def _shapes(per_seed: Sequence[SensorDataset]) -> tuple:
    """The distinct (shape, dtype) layouts of per-seed datasets: a cache key."""
    return tuple(dict.fromkeys(tuple((tuple(x.shape), str(x.dtype)) for x in one)
                               for one in per_seed))


@dataclasses.dataclass(frozen=True)
class EngineRun:
    """Result of one batched cell.  Metric leaves have leading (S, P)."""

    method: str
    cfg: hfl.HFLConfig
    seeds: tuple[int, ...]
    n_deployments: int
    metrics: dict[str, torch.Tensor]
    wall_s: float
    fresh_compile: bool

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.metrics[name]

    @property
    def f1(self) -> torch.Tensor:
        return self.metrics["f1"]

    @property
    def losses(self) -> torch.Tensor:
        """(S, P, T) per-round mean training loss."""
        return self.metrics["losses"]

    def seed_mean_std(self, name: str) -> tuple[float, float]:
        """Mean/std of a scalar metric over all (seed, deployment) trials."""
        v = self.metrics[name].to(torch.float32)
        return float(torch.mean(v)), float(torch.std(v, correction=0))


@dataclasses.dataclass(frozen=True)
class SweepRun:
    """Result of one config-axis sweep.  Metric leaves have leading
    (C, S, P) — config cell x seed x deployment."""

    method: str
    cfgs: tuple[hfl.HFLConfig, ...]   # resolved configs, input order
    seeds: tuple[int, ...]
    n_deployments: int
    metrics: dict[str, Any]
    classes: tuple[dict, ...]         # per-shape-class execution info
    wall_s: float

    def __getitem__(self, name: str) -> Any:
        return self.metrics[name]

    @property
    def compiled_programs(self) -> int:
        """Trial functions built fresh for THIS sweep (cache hits excluded)."""
        return sum(1 for c in self.classes if c["fresh_compile"])

    @property
    def n_classes(self) -> int:
        return len(self.classes)

    def cell(self, i: int) -> dict[str, torch.Tensor]:
        """Metrics of config cell ``i`` with the (S, P) trial axes kept."""
        return {k: v[i] for k, v in self.metrics.items()}

    def seed_mean_std(self, name: str, i: int) -> tuple[float, float]:
        v = self.metrics[name][i].to(torch.float32)
        return float(torch.mean(v)), float(torch.std(v, correction=0))


class Engine:
    """Unified batched front-end for the round-loop families.

    * ``run``   — the trainable families: flat FL (``core/flat_fl``:
      fedavg/fedprox/fedadam/scaffold/centralised), hierarchical FL
      (``core/hfl``: the hfl-* cooperation rules) and the asynchronous
      family (``core/async_fl``: ``hfl-async`` with an ``AsyncFLConfig``,
      its B trials' events folded into the kernels' axes as the rounds
      are);
    * ``sweep`` — ``run``/``audit`` over a whole CONFIG GRID: cells are
      grouped into shape-classes (identical static structure — enums,
      counts, compressor mode/bits, deployment geometry — and kernel
      scalars), each class ONE batched call over its cells' trials with
      per-trial knobs: a ``(C, S, P)`` grid;
    * ``audit`` — the training-free energy/participation replay of either
      family at paper scale, all trials at once;
    * ``reachability`` — the geometry-only Fig. 5 study;
    * ``score`` — fused anomaly scoring (``serving/score``);
    * ``pod_train_step`` — the pod family (``core/mesh_fl``), returned as
      a cached step for callers that own the pod and batch loop.
    """

    def __init__(
        self,
        *,
        compressor: str = "auto",
        shard_trials: bool = True,
        shard_clients: bool = False,
        client_chunk: int | None = None,
        hidden: tuple[int, ...] = (16, 8, 16),
        percentile: float = 99.0,
        point_adjusted: bool = False,
        device: torch.device | str | None = None,
    ) -> None:
        if compressor not in ("auto", "keep"):
            raise ValueError(f"compressor must be auto|keep, got {compressor!r}")
        if client_chunk is not None and (
            not isinstance(client_chunk, int) or client_chunk < 1
        ):
            raise ValueError(
                f"client_chunk must be None or a positive int, got {client_chunk!r}"
            )
        self.compressor = compressor
        self.shard_trials = shard_trials
        self.shard_clients = shard_clients
        self.client_chunk = client_chunk
        self.hidden = hidden
        self.percentile = percentile
        self.point_adjusted = point_adjusted
        self.device = device
        self._programs: dict[Any, Callable] = {}
        self.compile_count = 0
        self.call_log: list[dict] = []

    # ------------------------------------------------------------------
    # config / data resolution
    # ------------------------------------------------------------------

    def resolve_compressor(self, cc: comp.CompressorConfig) -> comp.CompressorConfig:
        """The engine's compressor default: the blockwise kernels."""
        if self.compressor == "keep" or not cc.enabled or cc.rho_s >= 1.0:
            return cc
        if cc.quant_bits != 8 and cc.quant_bits < 32:
            return cc  # kernels are int8-only; keep paper global numerics
        if cc.mode == "blockwise":
            return cc
        return cc.replace(mode="blockwise")

    def resolve_local_solver(self, ls: LocalTrainConfig) -> LocalTrainConfig:
        """The engine's local-train default.  The port's solver has no
        backend flags (the device picks the kernel or its plain version),
        so it resolves to itself; ``fused=False`` stays the opt-out."""
        return ls

    def resolve_config(self, cfg: hfl.HFLConfig) -> hfl.HFLConfig:
        """Apply the engine's defaults; an async config resolves through
        its ``base``.  ``Engine(client_chunk=...)`` stamps the fleet-axis
        chunk size into configs that leave it unset; an explicit
        per-config value always wins."""
        if isinstance(cfg, async_fl.AsyncFLConfig):
            return cfg.replace(base=self.resolve_config(cfg.base))
        kw: dict[str, Any] = dict(
            compressor=self.resolve_compressor(cfg.compressor),
            local_solver=self.resolve_local_solver(cfg.local_solver),
        )
        if cfg.client_chunk is None and self.client_chunk is not None:
            kw["client_chunk"] = self.client_chunk
        return cfg.replace(**kw)

    stack_datasets = staticmethod(hfl.stack_datasets)   # per-seed datasets on a leading axis

    def _as_stacked(self, ds: Any, seeds: Sequence[int]) -> list[SensorDataset]:
        """One dataset per seed: a per-seed callable's, a shared dataset
        (the same object for every seed, so it goes to the device once), or
        the slices of a dataset stacked along a leading ``len(seeds)`` axis."""
        if callable(ds):
            return [ds(s) for s in seeds]
        if ds.train.dim() == 3:  # one dataset shared by every seed
            return [ds] * len(seeds)
        if ds.train.shape[0] != len(seeds):
            raise ValueError(
                f"stacked dataset has {ds.train.shape[0]} entries for {len(seeds)} seeds"
            )
        return [SensorDataset(*(t[i] for t in ds)) for i in range(len(seeds))]

    @staticmethod
    def _trial_keys(seeds: Sequence[int], n_deployments: int) -> tuple[tuple[tuple[int, int],
                                                                             ...], ...]:
        """(S, P) trial keys ``(seed, j)``: trial (s, j) is the (j + 1)-th
        trial drawn from ``torch.Generator().manual_seed(seed)``, so column
        0 is exactly a sequential trial from ``seed``."""
        if not seeds or n_deployments < 1:
            raise ValueError(
                f"need >=1 seed and n_deployments >= 1, got {len(seeds)} seed(s), "
                f"n_deployments={n_deployments}"
            )
        return tuple(tuple((int(s), j) for j in range(n_deployments)) for s in seeds)

    @staticmethod
    def _draw(keys, draw: Callable[[int, torch.Generator], Any]) -> list:
        """``draw(s, generator)`` for every trial of the (S, P) grid in
        row-major order, each row's trials in turn from its seed's
        generator."""
        out = []
        for s, row in enumerate(keys):
            g = torch.Generator().manual_seed(row[0][0])
            out.extend(draw(s, g) for _ in row)
        return out

    # ------------------------------------------------------------------
    # program cache / placement / instrumentation
    # ------------------------------------------------------------------

    def _device(self) -> torch.device:
        """The engine's device: this process's card unless built with one."""
        return _device.resolve(self.device)

    @staticmethod
    def _world() -> int:
        """Ranks of the initialised default process group, else 1."""
        return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1

    def _client_mesh(self, method: str, per_seed: Sequence[SensorDataset]):
        """The client mesh of a ``run`` cell, or None: ``shard_clients``,
        more than one rank, a hierarchical or flat round method, and a
        sensor count the ranks divide."""
        world = self._world()
        if (not self.shard_clients or method in UNSHARDED or world <= 1
                or per_seed[0].train.shape[-3] % world):
            return None
        return sharding.client_mesh()

    def _trial_mesh(self, s_n: int, client_mesh: Any):
        """The ranks that split a cell's S seeds, or None: ``shard_trials``,
        no client mesh, more than one rank, and S a multiple of the ranks."""
        world = self._world()
        if not self.shard_trials or client_mesh is not None or world <= 1 or s_n % world:
            return None
        return sharding.client_mesh()

    def _get_program(self, cache_key: Any, build: Callable[[], Callable]):
        """The built trial function of ``cache_key`` (a partial of the
        batched trial function); ``compile_count`` counts those built."""
        fn = self._programs.get(cache_key)
        fresh = fn is None
        if fresh:
            fn = build()
            self._programs[cache_key] = fn
            self.compile_count += 1
        return fn, fresh

    def _timed_call(self, dev: torch.device, fn, *args, **kw):
        """(fn's output, wall seconds, kernel launches during the call)."""
        before = _launches()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        after = _launches()
        return out, wall, {k: after[k] - before[k] for k in after if after[k] != before[k]}

    def _log(self, **entry) -> None:
        self.call_log.append(entry)

    def take_log(self) -> list[dict]:
        """Drain the per-call log (benchmarks snapshot this into JSON)."""
        entries, self.call_log = self.call_log, []
        return entries

    def stats(self) -> dict:
        return {
            "compiled_programs": self.compile_count,
            "cached_programs": len(self._programs),
        }

    # ------------------------------------------------------------------
    # the families
    # ------------------------------------------------------------------

    def _run_program(self, method: str, dev: torch.device, return_params: bool,
                     client_mesh: Any = None) -> Callable:
        return functools.partial(
            exp.batched_trial_metrics, method, percentile=self.percentile,
            point_adjusted=self.point_adjusted, client_mesh=client_mesh,
            return_params=return_params, device=dev)

    def _run_class(self, fn, method, cells, keys, per_cell_ds, dev, trial_mesh: Any = None):
        """A shape class of C cells as ONE batched call over B = C * S * P
        trials: trial (c, s, j) takes what ``Engine.run(cells[c], ...)``
        draws for (s, j), the cells' datasets fold with the trials, and the
        knobs the cells differ in become (B,) values (:func:`_fold`);
        SCAFFOLD and the oracle get each trial's own config.  The draws
        (``experiment.draw_trial``) read only what the class signature
        holds (counts, the deployment, the fault layer's on/off and mode,
        the data shapes), so the (S, P) grid is drawn once and every cell
        takes it, as the reference's config axis shares its keys.  With
        ``trial_mesh`` this rank runs its rows of seeds of every cell.
        Returns (metrics (C, S, P, ...), wall, launches, swept knob
        paths)."""
        s_n = len(keys)
        if trial_mesh is not None:
            mine = trial_mesh.rows(s_n)
            keys, per_cell_ds = keys[mine], [one[mine] for one in per_cell_ds]
        reps = len(keys) * len(keys[0])
        drawn = self._draw(keys, lambda s, g: exp.draw_trial(g, per_cell_ds[0][s], cells[0],
                                                             self.hidden, method))
        inputs = drawn * len(cells)
        ds_list = [per_seed[s] for per_seed in per_cell_ds for s, row in enumerate(keys)
                   for _ in row]
        folded, swept = _fold(cells, reps)
        if method in exp.UNBATCHED:
            folded = [cfg for cfg in cells for _ in range(reps)]
        out, wall, launches = self._timed_call(dev, fn, inputs, ds_list, folded)
        out = _grid(out, len(cells), len(keys), len(keys[0]))
        if trial_mesh is not None:
            out = agg.tree_map(lambda t: trial_mesh.gather_rows(t, s_n, dim=1), out)
        return out, wall, launches, swept

    def _audit_class(self, fn, methods, cells, resolved, keys, d, dev):
        """An audit class of C cells as ONE batched call over B = C * S * P
        trials, each trial with its cell's method and payload bits (the
        resolved compressor's, ``l_u``) and the knobs the cells differ in
        as (B,) values; the (S, P) grid's deployments and mobility are
        drawn once for the class (they read only its deployment and round
        count).  Returns (metrics (C, S, P), wall, launches, swept
        knob paths)."""
        s_n, p_n = len(keys), len(keys[0])
        reps = s_n * p_n
        dep, mobility = self._audit_draws(cells[0], keys, dev)    # the class's draws, once
        dep = topo.Deployment(*(getattr(dep, f.name).repeat((len(cells),) + (1,) * (
            getattr(dep, f.name).dim() - 1)) for f in dataclasses.fields(topo.Deployment)))
        mobility = mobility.repeat(1, len(cells), 1, 1)
        bits = [float(comp.payload_bits(d, r.compressor)) for r in resolved]
        l_u = (bits[0] if _same(bits)
               else torch.tensor(bits, dtype=torch.float32).repeat_interleave(reps))
        folded, swept = _fold(cells, reps)
        per_trial = [m for m in methods for _ in range(reps)]
        out, wall, launches = self._timed_call(dev, fn, per_trial, folded, dep, mobility,
                                               l_u=l_u)
        if isinstance(l_u, torch.Tensor):
            swept = swept + ["l_u"]
        return _grid(out, len(cells), s_n, p_n), wall, launches, swept

    def run(
        self,
        method: str,
        cfg: hfl.HFLConfig,
        seeds: Sequence[int],
        ds: SensorDataset | Callable[[int], SensorDataset],
        *,
        n_deployments: int = 1,
        label: str | None = None,
        store: Any | None = None,
        publish_step: int | None = None,
    ) -> EngineRun:
        """Train + evaluate ``method`` for every (seed, deployment) trial.

        ``ds``: a per-seed callable, a single dataset (shared), or a
        dataset stacked along a leading ``len(seeds)`` axis.

        ``store``: optional ``checkpoint.CheckpointStore`` — publishes the
        trained params of trial (seeds[0], deployment 0) as round
        ``publish_step`` (default ``cfg.rounds``), the hand-off point to
        the serving path (``serving/service.ScoringService``).  Under a
        process group every rank returns the whole run: give the store to
        one rank.
        """
        exp._check_method(method)
        dev = self._device()
        cfg = self.resolve_config(cfg)
        seeds = tuple(int(s) for s in seeds)
        per_seed = self._as_stacked(ds, seeds)
        s_n, p_n = len(seeds), n_deployments
        keys = self._trial_keys(seeds, p_n)           # (S, P)
        return_params = store is not None
        shapes = _shapes(per_seed)
        client_mesh = self._client_mesh(method, per_seed)
        trial_mesh = self._trial_mesh(s_n, client_mesh)
        cache_key = ("run", method, _cfg_key(cfg), s_n, p_n, shapes, self.hidden,
                     self.percentile, self.point_adjusted,
                     client_mesh.size if client_mesh is not None else 0, return_params)
        fn, fresh = self._get_program(cache_key, lambda: self._run_program(
            method, dev, return_params, client_mesh))
        out, wall, launches, _ = self._run_class(fn, method, [cfg], keys, [per_seed], dev,
                                                 trial_mesh)
        out = {k: v[0] if k != "params" else [{n: t[0] for n, t in layer.items()} for layer in v]
               for k, v in out.items()}
        if store is not None:
            params = out.pop("params")
            store.publish(_base_cfg(cfg).rounds if publish_step is None else publish_step,
                          [{k: v[0, 0] for k, v in layer.items()} for layer in params])
        self._log(kind="run", method=method, label=label or method,
                  n_trials=s_n * p_n, wall_s=wall, fresh_compile=fresh,
                  compressor=_describe_compressor(_base_cfg(cfg).compressor, dev),
                  client_sharded=client_mesh is not None, trial_sharded=trial_mesh is not None,
                  batched=method not in exp.UNBATCHED, launches=launches)
        return EngineRun(method, cfg, seeds, p_n, out, wall, fresh)

    def _audit_draws(self, cfg: hfl.HFLConfig, keys, dev):
        """Each trial's deployment, then its (T, M, 3) mobility noise, from
        its seed (``experiment.audit_method``'s order), stacked."""
        def draw(_, g):
            return (topo.sample_deployment(g, cfg.deployment, device="cpu"),
                    torch.randn((cfg.rounds, cfg.deployment.n_fog, 3), generator=g))

        deps, mobility = zip(*self._draw(keys, draw))
        return topo.Deployment.stack(list(deps)).to(dev), torch.stack(mobility, dim=1).to(dev)

    def audit(
        self,
        method: str,
        cfg: hfl.HFLConfig,
        seeds: Sequence[int],
        *,
        d: int = 1352,
        n_deployments: int = 1,
        label: str | None = None,
    ) -> dict[str, torch.Tensor]:
        """Batched training-free energy/participation audit.

        Returns summed energies / mean participation with (S, P) leading
        axes; trial (s, 0) matches ``experiment.audit_method(seed=s)``.
        """
        self._sync_only(cfg)
        dev = self._device()
        cfg = self.resolve_config(cfg)
        seeds = tuple(int(s) for s in seeds)
        s_n, p_n = len(seeds), n_deployments
        keys = self._trial_keys(seeds, p_n)           # (S, P)
        cache_key = ("audit", method, cfg, s_n, p_n, d)
        fn, fresh = self._get_program(
            cache_key, lambda: functools.partial(exp.audit_trial, method, cfg, d=d))
        dep, mobility = self._audit_draws(cfg, keys, dev)
        out, wall, launches = self._timed_call(dev, fn, dep, mobility)
        self._log(kind="audit", method=method, label=label or method,
                  n_trials=s_n * p_n, wall_s=wall, fresh_compile=fresh,
                  compressor=_describe_compressor(cfg.compressor, dev), batched=True,
                  launches=launches)
        return _grid(out, s_n, p_n)

    # ------------------------------------------------------------------
    # config-axis sweeps
    # ------------------------------------------------------------------

    @staticmethod
    def stack_configs(cfgs: Sequence[hfl.HFLConfig]) -> dict[str, torch.Tensor]:
        """Stack same-shape-class configs: every knob leaf (the
        reference's pytree leaves), by its dotted field path, as a (C,)
        f32 tensor; a tensor leaf (the replayed ``arrival_delay_s``) as
        (C, ...).  ``sweep`` repeats the knobs the cells differ in S * P
        times into the (B,) values of its one call."""
        leaves = [_knob_leaves(c) for c in cfgs]
        return {k: torch.stack([torch.as_tensor(lv[k], dtype=torch.float32) for lv in leaves])
                for k in leaves[0]}

    @staticmethod
    def _sync_only(cfg: Any) -> None:
        if isinstance(cfg, async_fl.AsyncFLConfig):
            raise ValueError("the audit family is training-free and synchronous; it does not "
                             "take AsyncFLConfig cells")

    @staticmethod
    def _audit_normal(cfg: hfl.HFLConfig) -> hfl.HFLConfig:
        """Blank out the static fields the audit family never reads.

        The audit touches the compressor only through the uplink payload
        size — which the sweep feeds per cell — so cells that differ only
        in compressor/solver/server statics collapse into one shape-class.
        """
        Engine._sync_only(cfg)
        return cfg.replace(
            local_epochs=1,
            batch_size=32,
            server_opt="sgd",
            local_solver=LocalTrainConfig(),
            compressor=comp.CompressorConfig(),
            faults=flt.FaultConfig(),
            drift=drf.DriftConfig(),
            trim_frac=0.0,
            robust="mean",
            client_chunk=None,  # audits never run the client phase
        )

    def _sweep_classes(
        self, cfgs: Sequence[hfl.HFLConfig], family: str,
        ds_shapes: Sequence[tuple] | None,
    ) -> tuple[list[hfl.HFLConfig], dict]:
        """Group sweep cells into shape-classes, as the reference's
        ``Engine._sweep_classes`` does on its kernel backend.

        The signature is the config's static structure (:func:`_signature`:
        rule enum, round/epoch/event counts, compressor mode/bits/flags,
        deployment geometry, the fault and drift layers' on/off, the shape
        of a replayed ``arrival_delay_s``), plus for ``run`` the knobs the
        kernels take as scalars (:func:`_static_knobs`) and, for per-cell
        datasets, the data shapes.  Mixed enums/static shapes never share a
        class.
        """
        norm, groups = [], {}
        for i, rcfg in enumerate(cfgs):
            ncfg = self._audit_normal(rcfg) if family == "audit" else rcfg
            norm.append(ncfg)
            sig = (_signature(ncfg), _static_knobs(rcfg) if family == "run" else (),
                   ds_shapes[i] if ds_shapes is not None else None)
            groups.setdefault(sig, []).append(i)
        return norm, groups

    def sweep(
        self,
        method: str | Sequence[str],
        cfgs: Sequence[hfl.HFLConfig],
        seeds: Sequence[int],
        ds: Any = None,
        *,
        n_deployments: int = 1,
        family: str = "run",
        d: int = 1352,
        label: str | None = None,
    ) -> SweepRun:
        """Evaluate a whole config grid: ONE batched call per
        shape-class (:meth:`_sweep_classes`) over its cells' (seed,
        deployment) trials, the knobs the cells differ in as per-trial
        values (:meth:`_run_class`, :meth:`_audit_class`).

        ``family="run"`` trains and evaluates (``ds`` required: one
        dataset/callable shared by every cell, or a length-C sequence of
        per-cell datasets, each in any form ``Engine.run`` accepts);
        ``family="audit"`` replays the training-free energy accounting
        (``d`` = model size; ``ds`` ignored), and ``method`` may then be a
        length-C sequence: each trial takes its cell's method and payload.
        With ``shard_trials`` under a process group, rank r runs its rows
        of seeds of every cell.

        Returns a :class:`SweepRun` with metric leaves shaped (C, S, P);
        cell ``i`` equals ``Engine.run(cfgs[i], ...)`` / ``Engine.audit``
        (to float tolerance: a plain product or sum over a larger trial
        axis may reassociate).
        """
        if family not in ("run", "audit"):
            raise ValueError(f"family must be run|audit, got {family!r}")
        if not cfgs:
            raise ValueError("need at least one config cell")
        if isinstance(method, str):
            methods = (method,) * len(cfgs)
        else:
            methods = tuple(method)
            if len(methods) != len(cfgs):
                raise ValueError(f"got {len(methods)} methods for {len(cfgs)} configs")
            if family == "run" and len(set(methods)) > 1:
                raise ValueError(
                    "per-cell methods are audit-only (the training family's round loops "
                    "differ structurally per method)"
                )
        uniq = tuple(dict.fromkeys(methods))
        method_desc = uniq[0] if len(uniq) == 1 else "+".join(uniq)
        if family == "run":
            exp._check_method(uniq[0])
        dev = self._device()
        seeds = tuple(int(s) for s in seeds)
        s_n, p_n = len(seeds), n_deployments
        keys = self._trial_keys(seeds, p_n)           # (S, P)
        rcfgs = tuple(self.resolve_config(c) for c in cfgs)

        stacked_ds, ds_shapes = None, None
        if family == "run":
            if ds is None:
                raise ValueError("family='run' sweeps need a dataset")
            if isinstance(ds, (list, tuple)) and not isinstance(ds, SensorDataset):
                if len(ds) != len(rcfgs):
                    raise ValueError(f"got {len(ds)} datasets for {len(rcfgs)} configs")
                stacked_ds = [self._as_stacked(one, seeds) for one in ds]
            else:
                stacked_ds = [self._as_stacked(ds, seeds)] * len(rcfgs)
            ds_shapes = [_shapes(one) for one in stacked_ds]

        norm, groups = self._sweep_classes(rcfgs, family, ds_shapes)
        trial_mesh = self._trial_mesh(s_n, None) if family == "run" else None
        per_cfg: list[Any] = [None] * len(rcfgs)
        classes, wall_total = [], 0.0
        for sig, idxs in groups.items():
            rep = rcfgs[idxs[0]]
            cache_key = ("sweep", family, uniq, sig, len(idxs), s_n, p_n, d, self.hidden,
                         self.percentile, self.point_adjusted)
            if family == "run":
                fn, fresh = self._get_program(
                    cache_key, lambda: self._run_program(uniq[0], dev, False))
                out, wall, launches, swept = self._run_class(
                    fn, uniq[0], [norm[i] for i in idxs], keys, [stacked_ds[i] for i in idxs],
                    dev, trial_mesh)
            else:
                fn, fresh = self._get_program(
                    cache_key, lambda: functools.partial(exp.audit_trials, d=d))
                out, wall, launches, swept = self._audit_class(
                    fn, [methods[i] for i in idxs], [norm[i] for i in idxs],
                    [rcfgs[i] for i in idxs], keys, d, dev)
            for pos, i in enumerate(idxs):
                per_cfg[i] = {k: v[pos] for k, v in out.items()}
            info = dict(
                indices=tuple(idxs), n_cells=len(idxs), wall_s=wall, fresh_compile=fresh,
                compressor=_describe_compressor(_base_cfg(rep).compressor, dev),
                knobs=sorted(swept),
            )
            classes.append(info)
            wall_total += wall
            self._log(kind=f"sweep-{family}", method=method_desc,
                      label=label or f"sweep:{method_desc}", n_cells=len(idxs),
                      n_trials=len(idxs) * s_n * p_n, wall_s=wall, fresh_compile=fresh,
                      compressor=info["compressor"], trial_sharded=trial_mesh is not None,
                      batched=family == "audit" or uniq[0] not in exp.UNBATCHED,
                      launches=launches)

        # Stack per metric into (C, S, P, ...) where shapes agree across
        # cells; a metric whose trailing shape differs (per-round losses
        # under different round counts) stays a C-tuple.
        metrics = {}
        for name in per_cfg[0]:
            vals = [m[name] for m in per_cfg]
            if len({tuple(v.shape) for v in vals}) == 1:
                metrics[name] = torch.stack(vals)
            else:
                metrics[name] = tuple(vals)
        return SweepRun(method_desc, rcfgs, seeds, p_n, metrics, tuple(classes), wall_total)

    def reachability(
        self,
        cfg: hfl.HFLConfig,
        seeds: Sequence[int],
        *,
        n_deployments: int = 1,
        label: str | None = None,
    ) -> dict[str, torch.Tensor]:
        """Batched geometry-only reachability study (the Fig. 5 family).

        Training- and model-free: each trial samples a deployment and
        computes the direct-gateway / fog-assisted / fog-to-gateway
        feasibility fractions.  Returns (S, P)-leading tensors; trial
        (s, j) matches the (j + 1)-th sequential ``topology.sample_deployment``
        + ``participation.reachability`` from ``torch.Generator().manual_seed(s)``.
        """
        dev = self._device()
        seeds = tuple(int(s) for s in seeds)
        s_n, p_n = len(seeds), n_deployments
        keys = self._trial_keys(seeds, p_n)           # (S, P)
        cache_key = ("reach", cfg.deployment, cfg.channel, s_n, p_n)

        def build():
            def trials(dep):
                r = part.reachability(dep, cfg.channel)
                return {"direct_gateway": r.direct_gateway, "fog_assisted": r.fog_assisted,
                        "fog_to_gateway": r.fog_to_gateway}
            return trials

        fn, fresh = self._get_program(cache_key, build)
        dep = topo.Deployment.stack(self._draw(
            keys, lambda _, g: topo.sample_deployment(g, cfg.deployment, device="cpu"))).to(dev)
        out, wall, launches = self._timed_call(dev, fn, dep)
        self._log(kind="reachability", method="reachability",
                  label=label or "reachability", n_trials=s_n * p_n,
                  wall_s=wall, fresh_compile=fresh, compressor="n/a", batched=True,
                  launches=launches)
        return _grid(out, s_n, p_n)

    def score(
        self,
        params: Any,
        x: Any,
        tau: Any,
        *,
        n_trial_axes: int = 0,
        fused: bool = True,
        label: str | None = None,
    ):
        """Batched fused anomaly scoring — the serving family.

        ``x``: telemetry ``(..., d)``; the fused score kernel
        (``serving/score``: the ``fused_score_f32`` kernel on the card,
        its plain version on the CPU) flattens everything below the trial
        axes into one row sweep, on the device of ``params``.  With
        ``n_trial_axes = 0`` that is ONE launch for all of ``x``;
        otherwise ``params`` layers, ``x`` and ``tau`` (broadcast to
        ``x.shape[:-1]``) lead with the trial axes (e.g. the (S, P) grid
        of a training cell) and each trial is one launch.  Returns a
        ``ScoreResult`` with leaves shaped ``x.shape[:-1]``.
        """
        from repro_torch.serving.score import ScoreResult
        from repro_torch.serving.score import score as serving_score_fn

        dev = params[0]["w"].device
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        tau_b = torch.broadcast_to(torch.as_tensor(tau, dtype=torch.float32, device=dev),
                                   x.shape[:-1])
        trial_shape = tuple(x.shape[:n_trial_axes])
        p_shapes = tuple((tuple(t.shape), str(t.dtype)) for layer in params
                         for t in layer.values())
        cache_key = ("score", p_shapes, tuple(x.shape), str(x.dtype), n_trial_axes, fused)

        def build():
            def trials(p, xx, tt):
                if not trial_shape:
                    return serving_score_fn(p, xx, tt, fused=fused)
                errs, flags = [], []
                for idx in itertools.product(*map(range, trial_shape)):
                    one = [{k: v[idx] for k, v in layer.items()} for layer in p]
                    r = serving_score_fn(one, xx[idx], tt[idx], fused=fused)
                    errs.append(r.error)
                    flags.append(r.flag)
                lead = tuple(xx.shape[:-1])
                return ScoreResult(torch.stack(errs).reshape(lead),
                                   torch.stack(flags).reshape(lead))
            return trials

        fn, fresh = self._get_program(cache_key, build)
        out, wall, launches = self._timed_call(dev, fn, params, x, tau_b)
        self._log(kind="score", method="score", label=label or "score",
                  n_trials=int(x[..., 0].numel()), wall_s=wall, fresh_compile=fresh,
                  compressor="fused" if fused else "unfused", batched=not trial_shape,
                  launches=launches)
        return out

    def pod_train_step(
        self,
        model_cfg: Any,
        mesh: Any = None,
        *,
        rho_s: float = 0.05,
        self_weight: float = 0.5,
        mode: str = "int8",
        local_epochs: int = 1,
    ) -> Callable:
        """The pod family's compressed step (``core/mesh_fl``), built once
        per key and cached: ``step(params, err, batch) -> (params', err',
        loss)``.  ``mesh`` is a ``launch/sharding.ClientMesh`` whose ranks
        are the pods, or a ``launch/sharding.PodDataMesh`` (pods of data
        ranks); ``None`` means one pod on the engine's device (err
        from ``mesh_fl.init_err(params, 1)``).  ``local_epochs > 1`` runs E
        local passes per pod (delta exchange)."""
        from repro_torch.core import mesh_fl

        dev = _device.resolve(self.device)
        cache_key = ("pod", repr(model_cfg), mesh, rho_s, self_weight, mode, local_epochs)

        def build():
            step = mesh_fl.make_pod_hfl_train_step(
                model_cfg, mesh, rho_s=rho_s, self_weight=self_weight, mode=mode,
                local_epochs=local_epochs)

            def on_device(params, err, batch):
                return step(params, err, {k: v.to(dev) for k, v in batch.items()})

            return on_device

        fn, _ = self._get_program(cache_key, build)
        return fn

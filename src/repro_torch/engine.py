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
the log).  Results come back with leading (S, P) axes.

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
Entry points run on the card (``device=None``) unless the engine is built
with ``device="cpu"``.  The reference shards trials or clients over more
than one device; the port does not yet (``ROADMAP.md`` queue 1 item 15):
on one device placement is the identity, as the reference's, and with
more than one CUDA device visible a call raises ``NotImplementedError``
(build the engine with ``shard_trials=False`` to run on ``cuda:0``).
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import time
from typing import Any, Callable, Sequence

import torch

from repro_torch import device as _device
from repro_torch.core import compression as comp
from repro_torch.core import drift as drf
from repro_torch.core import faults as flt
from repro_torch.core import hfl
from repro_torch.core import participation as part
from repro_torch.core import topology as topo
from repro_torch.data.synthetic import SensorDataset
from repro_torch.kernels import fused_agg, fused_score, local_train, quant8, robust_agg, topk_ef
from repro_torch.launch import experiment as exp
from repro_torch.optim.sgd import LocalTrainConfig

UNPORTED_DEVICES = ("sharding over more than one device is not ported yet "
                    "(ROADMAP.md queue 1 item 15)")
UNPORTED_POD = "pod_train_step (the TPU-mesh family) is not ported yet (ROADMAP.md queue 1 item 15)"

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


def _structure(x: Any) -> Any:
    """A config's static structure: every float leaf blanked (a swept
    knob), every other field kept (enums, counts, modes, flags, widths)."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            (f.name, _structure(getattr(x, f.name))) for f in dataclasses.fields(x))
    if isinstance(x, tuple):
        return tuple(_structure(v) for v in x)
    return None if isinstance(x, float) else x


def _float_leaves(x: Any, path: str = "") -> dict[str, float]:
    if dataclasses.is_dataclass(x):
        out: dict[str, float] = {}
        for f in dataclasses.fields(x):
            out.update(_float_leaves(getattr(x, f.name), f"{path}{f.name}."))
        return out
    if isinstance(x, tuple):
        out = {}
        for i, v in enumerate(x):
            out.update(_float_leaves(v, f"{path}{i}."))
        return out
    return {path[:-1]: x} if isinstance(x, float) else {}


def _grid(out: dict[str, Any], s_n: int, p_n: int) -> dict[str, Any]:
    """Leading B = S * P axis -> (S, P); ``params`` layers alike."""
    grid = {}
    for k, v in out.items():
        if k == "params":
            grid[k] = [{n: t.reshape((s_n, p_n) + tuple(t.shape[1:])) for n, t in layer.items()}
                       for layer in v]
        else:
            grid[k] = v.reshape((s_n, p_n) + tuple(v.shape[1:]))
    return grid


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
      fedavg/fedprox/fedadam/scaffold/centralised) and hierarchical FL
      (``core/hfl``: the hfl-* cooperation rules); the asynchronous
      family (``hfl-async``) raises until it is ported (queue 1 item 13);
    * ``sweep`` — ``run``/``audit`` over a whole CONFIG GRID: cells are
      grouped into shape-classes (identical static structure — enums,
      counts, compressor mode/bits, deployment geometry), one trial
      function per class, its cells one after another, each a batched
      (S, P) call: a ``(C, S, P)`` grid;
    * ``audit`` — the training-free energy/participation replay of either
      family at paper scale, all trials at once;
    * ``reachability`` — the geometry-only Fig. 5 study;
    * ``score`` — fused anomaly scoring (``serving/score``);
    * ``pod_train_step`` — the TPU-mesh family, not ported (item 15).
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
        """Apply the engine's defaults.  ``Engine(client_chunk=...)``
        stamps the fleet-axis chunk size into configs that leave it unset;
        an explicit per-config value always wins."""
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
        """The engine's device.  ``shard_clients=True`` on one device runs
        the default placement, as the reference's on one device; with more
        than one CUDA device visible, sharding raises (item 15)."""
        dev = _device.resolve(self.device)
        if dev.type == "cuda" and torch.cuda.device_count() > 1 and (
                self.shard_trials or self.shard_clients):
            raise NotImplementedError(UNPORTED_DEVICES)
        return dev

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

    def _place(self, tree: Any, n_leading: int) -> Any:
        """Placement of the inputs: the identity on one device."""
        return tree

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

    def _run_program(self, method: str, dev: torch.device, return_params: bool) -> Callable:
        return functools.partial(
            exp.batched_trial_metrics, method, percentile=self.percentile,
            point_adjusted=self.point_adjusted, return_params=return_params, device=dev)

    def _run_cell(self, fn, method, cfg, keys, per_seed: list[SensorDataset], dev):
        """Draw every trial of the (S, P) grid on the host, then run them
        in one batched call: (metrics (S, P, ...), wall, launches)."""
        inputs = self._draw(keys, lambda s, g: exp.draw_trial(g, per_seed[s], cfg, self.hidden,
                                                              method))
        ds_list = [per_seed[s] for s, row in enumerate(keys) for _ in row]
        out, wall, launches = self._timed_call(dev, fn, inputs, ds_list, cfg)
        return _grid(out, len(keys), len(keys[0])), wall, launches

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
        the serving path (``serving/service.ScoringService``).
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
        cache_key = ("run", method, cfg, s_n, p_n, shapes, self.hidden, self.percentile,
                     self.point_adjusted, 0, return_params)
        fn, fresh = self._get_program(cache_key,
                                      lambda: self._run_program(method, dev, return_params))
        out, wall, launches = self._run_cell(fn, method, cfg, keys, self._place(per_seed, s_n),
                                             dev)
        if store is not None:
            params = out.pop("params")
            store.publish(cfg.rounds if publish_step is None else publish_step,
                          [{k: v[0, 0] for k, v in layer.items()} for layer in params])
        self._log(kind="run", method=method, label=label or method,
                  n_trials=s_n * p_n, wall_s=wall, fresh_compile=fresh,
                  compressor=_describe_compressor(cfg.compressor, dev),
                  client_sharded=False, batched=method not in exp.UNBATCHED, launches=launches)
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
        """Stack same-shape-class configs: every float leaf (a swept knob),
        by its dotted field path, as a (C,) f32 tensor."""
        leaves = [_float_leaves(c) for c in cfgs]
        return {k: torch.tensor([lv[k] for lv in leaves], dtype=torch.float32)
                for k in leaves[0]}

    @staticmethod
    def _audit_normal(cfg: hfl.HFLConfig) -> hfl.HFLConfig:
        """Blank out the static fields the audit family never reads.

        The audit touches the compressor only through the uplink payload
        size — which the sweep feeds per cell — so cells that differ only
        in compressor/solver/server statics collapse into one shape-class.
        """
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
        """Group sweep cells into shape-classes.

        The signature is the config's static structure (every field but
        the float knobs: rule enum, round/epoch counts, compressor
        mode/bits/flags, deployment geometry) plus, for per-cell datasets,
        the data shapes.  Mixed enums/static shapes never share a class.
        """
        norm, groups = [], {}
        for i, rcfg in enumerate(cfgs):
            ncfg = self._audit_normal(rcfg) if family == "audit" else rcfg
            norm.append(ncfg)
            sig = (_structure(ncfg), ds_shapes[i] if ds_shapes is not None else None)
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
        """Evaluate a whole config grid: ONE trial function per
        shape-class, its cells run one after another, each as one batched
        call over the (seed, deployment) trial grid.

        ``family="run"`` trains and evaluates (``ds`` required: one
        dataset/callable shared by every cell, or a length-C sequence of
        per-cell datasets, each in any form ``Engine.run`` accepts);
        ``family="audit"`` replays the training-free energy accounting
        (``d`` = model size; ``ds`` ignored), and ``method`` may then be a
        length-C sequence.

        Returns a :class:`SweepRun` with metric leaves shaped (C, S, P);
        cell ``i`` equals ``Engine.run(cfgs[i], ...)`` / ``Engine.audit``.
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
        per_cfg: list[Any] = [None] * len(rcfgs)
        classes, wall_total = [], 0.0
        for sig, idxs in groups.items():
            rep = rcfgs[idxs[0]]
            cache_key = ("sweep", family, uniq, sig, len(idxs), s_n, p_n, d, self.hidden,
                         self.percentile, self.point_adjusted)
            if family == "run":
                fn, fresh = self._get_program(
                    cache_key, lambda: self._run_program(uniq[0], dev, False))
            else:
                fn, fresh = self._get_program(
                    cache_key, lambda: functools.partial(exp.audit_trial, d=d))
            wall, launches = 0.0, {}
            for i in idxs:
                if family == "run":
                    out, w, ln = self._run_cell(fn, uniq[0], norm[i], keys, stacked_ds[i], dev)
                else:
                    dep, mobility = self._audit_draws(norm[i], keys, dev)
                    l_u = float(comp.payload_bits(d, rcfgs[i].compressor))
                    out, w, ln = self._timed_call(dev, fn, methods[i], norm[i], dep, mobility,
                                                  l_u=l_u)
                    out = _grid(out, s_n, p_n)
                per_cfg[i] = out
                wall += w
                for k, v in ln.items():
                    launches[k] = launches.get(k, 0) + v
            stacked_knobs = self.stack_configs([norm[i] for i in idxs])
            info = dict(
                indices=tuple(idxs), n_cells=len(idxs), wall_s=wall, fresh_compile=fresh,
                compressor=_describe_compressor(rep.compressor, dev),
                knobs=sorted(k for k, v in stacked_knobs.items() if bool((v != v[0]).any())),
            )
            classes.append(info)
            wall_total += wall
            self._log(kind=f"sweep-{family}", method=method_desc,
                      label=label or f"sweep:{method_desc}", n_cells=len(idxs),
                      n_trials=len(idxs) * s_n * p_n, wall_s=wall, fresh_compile=fresh,
                      compressor=info["compressor"],
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

    def pod_train_step(self, *args: Any, **kwargs: Any) -> Callable:
        """The TPU-mesh pod step (reference ``core/mesh_fl``): not ported."""
        raise NotImplementedError(UNPORTED_POD)

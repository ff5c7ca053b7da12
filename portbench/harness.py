"""The benchmark's run: set-up, a closed-loop window of calls, an optional
device trace, the check against the reference, and the result line.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration and traffic mix, whose parameters sit in
``configs/<config>.json`` and ``traffic/<traffic>.json``; the mix names
its method, whose reference is ``reference/<method>.py`` (``-`` read as
``_``); the limits of its comparison sit in ``limits/<cell>.json``; each
per-layer metric's reader in ``metrics/<metric>.py``; each device kernel
the trace counts in ``kernels/<kernel>.json``.  An unknown name is an
error, and so is a knob that the method's reference does not implement.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import random
import statistics
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from . import check
from .inputs import synthetic, trial
from .reference import common as ref_common

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names, compared whole
HELD_CALLS = 4          # window calls, drawn from the seed, whose answers are kept and checked
WARM_CALLS = 2
TRACED_CALLS = 1


class UnknownName(KeyError):
    pass


def _json(path: Path, kind: str, name: str) -> dict:
    if not path.is_file():
        raise UnknownName(f"unknown {kind} {name!r}: no {path.relative_to(BENCH.parent)}")
    return json.loads(path.read_text())


@dataclass
class Cell:
    name: str
    entry: dict         # the cell's BENCHMARK.json entry
    cfg: dict           # configs/<config>.json
    mix: dict           # traffic/<traffic>.json
    limits: dict        # limits/<cell>.json

    @property
    def dims(self) -> tuple[int, ...]:
        m = self.cfg["model"]
        return (m["feature_dim"], *m["hidden"], m["feature_dim"])

    @property
    def trials(self) -> int:
        return self.mix["trials"]

    @property
    def rounds(self) -> int:
        return self.cfg["training"]["rounds"]

    @property
    def client_rounds(self) -> int:
        """Sensor updates one call completes: B trials x N sensors x T rounds."""
        return self.trials * self.cfg["deployment"]["n_sensors"] * self.rounds

    def reference_view(self) -> dict:
        """The traffic's round knobs with the configuration's rounds."""
        return {**self.mix, "rounds": self.rounds}

    @property
    def method(self):
        """The reference module of the mix's method."""
        return method_reference(self.mix["method"])


def method_reference(method: str):
    """``reference/<method>.py`` (``-`` read as ``_``), the module whose
    ``check(cfg, mix)`` and ``train(...)`` stand for ``method``."""
    module = method.replace("-", "_")
    if not module.isidentifier() or not (BENCH / "reference" / f"{module}.py").is_file():
        raise UnknownName(f"unknown method {method!r}: no reference/{module}.py")
    return importlib.import_module(f"{__package__}.reference.{module}")


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``bench_dir``."""

    def __init__(self, root: Path = ROOT, bench_dir: Path = BENCH):
        self.bench_dir = bench_dir
        self.spec = json.loads((root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> Cell:
        entry = next((w for w in self.spec["workloads"] if w["name"] == name), None)
        if entry is None:
            raise UnknownName(f"unknown workload {name!r}")
        d = self.bench_dir
        cell = Cell(name, entry,
                    _json(d / "configs" / f"{entry['config']}.json", "config", entry["config"]),
                    _json(d / "traffic" / f"{entry['traffic']}.json", "traffic",
                          entry["traffic"]),
                    _json(d / "limits" / f"{name}.json", "limits", name))
        unknown = set(cell.limits) - set(check.NUMBERS)
        if unknown:
            raise UnknownName(f"unknown numbers {sorted(unknown)} in limits/{name}.json")
        cell.method.check(cell.cfg, cell.mix)
        return cell

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The metrics a run of ``cell`` reports: the end-to-end ones, or
        with ``trace`` the per-layer ones, each where its ``workloads``
        (when given) name the cell."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """The ``read(ctx)`` of ``metrics/<metric>.py``."""
        path = self.bench_dir / "metrics" / f"{metric}.py"
        if not path.is_file():
            raise UnknownName(f"unknown per-layer metric {metric!r}: no reader {path.name}")
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def draw(cell: Cell, seed: int, device: torch.device) -> list[tuple]:
    """B trials' inputs, trial b from a generator on ``device`` seeded with
    ``B * seed + b``: its telemetry, initial params, deployment and draws."""
    cfg, mix = cell.cfg, cell.mix
    dp, trn = cfg["deployment"], cfg["training"]
    faults = mix.get("faults")
    out = []
    for b in range(cell.trials):
        g = torch.Generator(device=device)
        g.manual_seed(cell.trials * seed + b)
        tel = synthetic.generate(g, {**cfg["data"], "n_sensors": dp["n_sensors"]})
        params = trial.init_params(g, cell.dims)
        dep = trial.sample_deployment(g, dp)
        d = sum(a * c + c for a, c in zip(cell.dims[:-1], cell.dims[1:]))
        draws = trial.draw_rounds(
            g, trn["rounds"], dp["n_fog"], dp["n_sensors"], cfg["data"]["train_len"],
            trn["batch_size"], trn["local_epochs"], faults is not None,
            bool(faults) and faults.get("byz_mode") == "gauss", d)
        out.append((tel, params, dep, draws))
    return out


def stacked(trials: list[tuple]):
    """The B trials as the reference reads them: telemetry (B, ...),
    params (B, ...), deployment (B, ...) and draws (T, B, ...)."""
    tel = synthetic.Telemetry(*(torch.stack(ts) for ts in zip(*(t[0] for t in trials))))
    params = [{k: torch.stack([t[1][i][k] for t in trials]) for k in ("w", "b")}
              for i in range(len(trials[0][1]))]
    dep = trial.Deployment(*(torch.stack(ts) for ts in zip(*(t[2] for t in trials))))
    draws = trial.Draws(*(None if xs[0] is None else torch.stack(xs, dim=1)
                          for xs in zip(*(t[3] for t in trials))))
    return tel, params, dep, draws


def program_flat(out: dict) -> torch.Tensor:
    """The program's trained params (B, d), in the ravel order."""
    return ref_common.ravel([{k: layer[k] for k in ("w", "b")} for layer in out["params"]])


def reference(cell: Cell, trials: list[tuple], lowp: bool = False):
    """The reference's batch on the drawn inputs: its summary with
    ``"flat"`` (B, d), and the stacked inputs it read."""
    tel, params, dep, draws = stacked(trials)
    flat, per_round = cell.method.train(cell.cfg, cell.reference_view(), tel, params, dep,
                                        draws, lowp=lowp)
    summary = ref_common.summary(per_round)
    summary["flat"] = flat
    return summary, (tel, params, dep, draws)


def judge(cell: Cell, outs: list[dict], ref: dict, stacked_in) -> tuple[dict, int]:
    """Each kept answer against the reference: (the worst of each number,
    the answers that failed)."""
    tel, params, _, _ = stacked_in
    flat0 = ref_common.ravel(params)
    worst = dict.fromkeys(check.NUMBERS, 0.0)
    failed = 0
    for out in outs:
        flat = program_flat(out)
        ev = ref_common.evaluate(flat, cell.dims, tel, cell.mix["percentile"])
        found = check.numbers(out, flat, ref, ev, flat0, cell.dims)
        failed += not check.verdict(found, cell.limits)
        for k, v in found.items():
            worst[k] = v if (math.isnan(v) or math.isnan(worst[k])) else max(worst[k], v)
    return worst, failed


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Context:
    """What a per-layer metric's reader may read."""

    cell: Cell
    trace: object | None        # trace.Trace of the traced calls, or None
    client_rounds: int          # completed in the window
    window_s: float


def run(cell: Cell, bench: Bench, seed: int, seconds: float, traced: bool,
        device: torch.device, program_cls, t_start: float, log=print) -> dict:
    """One run of ``cell``: returns the result line's dict (its metrics
    chosen by ``traced``)."""
    t_draw = time.perf_counter()
    trials = draw(cell, seed, device)
    _sync(device)
    prog = program_cls(cell.cfg, cell.mix, device)
    prepared = prog.inputs(trials)

    def call():
        out = prog.call(prepared)
        _sync(device)
        return out

    warm = [time.perf_counter()]
    for _ in range(WARM_CALLS):
        call()
        warm.append(time.perf_counter())
    warm_s = warm[-1] - warm[-2]
    log(f"set-up: {t_draw - t_start} s to the draw, inputs drawn in {warm[0] - t_draw} s, "
        f"warm calls {[b - a for a, b in zip(warm, warm[1:])]} s")
    rng = random.Random(seed)
    expect = max(1, int(seconds / max(warm_s, 1e-6)))
    held = set(rng.sample(range(max(1, expect // 2)), min(HELD_CALLS, max(1, expect // 2))))
    setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    kept, lat = [], []
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    calls = 0
    while True:
        c0 = time.perf_counter()
        out = call()
        c1 = time.perf_counter()
        lat.append(c1 - c0)
        if calls in held:
            kept.append(out)
        calls += 1
        if c1 - t0 >= seconds:
            break
    window_s = c1 - t0
    if calls - 1 not in held:
        kept.append(out)              # the last answer too
    window_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: {found}")

    tr = None
    if traced:
        from . import trace as trace_mod
        tr = trace_mod.capture(call, TRACED_CALLS, cell.rounds, prog.launches, device)
        for kernel, (k, n) in sorted(tr.kept.items()):
            log(f"profiler kept {k} of {n} launches of {kernel}")
        if not tr.complete:
            log("profiler dropped device activities: no share built on the trace is written")
    del prepared, prog, out

    ref, stacked_in = reference(cell, trials)
    worst, failed = judge(cell, kept, ref, stacked_in)
    correct = check.verdict(worst, cell.limits) and failed == 0

    client_rounds = calls * cell.client_rounds
    metrics = {}
    if traced:
        ctx = Context(cell, tr, client_rounds, window_s)
        for m in bench.metrics(cell.name, trace=True):
            value = bench.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {
            "client_rounds_per_s": client_rounds / window_s,
            "trial_p95_ms": 1e3 * _p95(lat),
            "peak_device_gib": window_peak / 2**30,
            "setup_s": setup_s,
        }
        for m in bench.metrics(cell.name, trace=False):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(max(setup_peak, window_peak))}
    result = {"correct": bool(correct), "attempted": calls, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    log(f"window: {calls} calls in {window_s} s (last warm call {warm_s} s), "
        f"{len(kept)} answers checked")
    result["checks"] = {k: {"value": worst[k], "limit": v} for k, v in cell.limits.items()}
    return result


def _p95(values: list[float]) -> float:
    """The 95th percentile, linearly interpolated between order statistics
    (``statistics.quantiles``' inclusive method)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[-1]

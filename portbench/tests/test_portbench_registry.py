"""The harness finds configurations, traffic mixes, limits and metric
readers by the names in ``BENCHMARK.json``, refuses unknown names, and
takes a new cell and a new per-layer metric from new files alone."""
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from conftest import SEED, tiny
from portbench import harness, trace
from portbench.program import Program

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_loads(bench):
    for w in bench.spec["workloads"]:
        cell = bench.cell(w["name"])
        assert cell.cfg["name"] == w["config"]
        assert cell.limits and set(cell.limits) <= set(harness.check.NUMBERS)
        assert cell.trials >= 1 and cell.rounds >= 1


def test_every_metric_has_a_reader(bench):
    for m in bench.spec["per_layer"]:
        assert callable(bench.reader(m["name"]))


@pytest.mark.parametrize("kind", ["workload", "metric"])
def test_unknown_names_are_refused(bench, kind):
    with pytest.raises(harness.UnknownName):
        if kind == "workload":
            bench.cell("no-such-cell")
        else:
            bench.reader("no_such_metric")


def test_contract_shape(bench):
    spec = bench.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [x["name"] for x in spec["configs"] + spec["workloads"] + spec["end_to_end"]
             + spec["per_layer"]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in spec[group]}) == len(spec[group])
    assert all(UNIT.match(m["unit"]) for m in spec["end_to_end"] + spec["per_layer"])
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert {"client_rounds_per_s", "trial_p95_ms", "peak_device_gib", "setup_s"} <= e2e
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert m["moves"] == "client_rounds_per_s"
        assert set(m["workloads"]) <= cells
    for c in spec["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")


def _copy(tmp_path: Path) -> Path:
    shutil.copytree(harness.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_new_cell_metric_and_kernel_need_only_new_files(tmp_path):
    """The chunked fleet cell of PERF.md's open questions comes in by data
    alone: a traffic mix, its limits, a metric reader and a kernel file,
    with their ``BENCHMARK.json`` entries; it loads and runs correct."""
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    bench_dir = root / "portbench"
    mix = json.loads((bench_dir / "traffic" / "fused-b1.json").read_text())
    mix.update(client_chunk=512, why="the fleet's clients 512 at a time on the sparse wire")
    (bench_dir / "traffic" / "wire512-b1.json").write_text(json.dumps(mix))
    (bench_dir / "limits" / "iout10k-wire.json").write_text(
        (bench_dir / "limits" / "iout10k-fused.json").read_text())
    (bench_dir / "metrics" / "calls_traced.py").write_text(
        "def read(ctx):\n    return None if ctx.trace is None else float(ctx.trace.calls)\n")
    (bench_dir / "kernels" / "new_kernel.json").write_text(
        json.dumps({"counter": "new_op", "launches_per_count": 1.0, "what": "a new kernel"}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "iout10k-wire", "config": "iout-10k",
                              "traffic": "wire512-b1", "chips": 1, "why": "chunked wire"})
    spec["per_layer"].append({"name": "calls_traced", "unit": "calls", "better": "higher",
                              "source": "device_trace", "layer": "device",
                              "moves": "client_rounds_per_s", "workloads": ["iout10k-wire"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = harness.Bench(root, bench_dir)
    cell = bench.cell("iout10k-wire")
    assert cell.mix["client_chunk"] == 512 and cell.cfg["name"] == "iout-10k"
    names = [m["name"] for m in bench.metrics("iout10k-wire", trace=True)]
    assert "calls_traced" in names and "fused_agg_roofline" not in names
    assert bench.reader("calls_traced")(type("Ctx", (), {"trace": None})()) is None
    assert trace.load_kernels(bench_dir / "kernels")["new_kernel"] == ("new_op", 1.0)
    res = harness.run(tiny(cell), bench, SEED, 0.3, False, torch.device("cpu"), Program, 0.0,
                      log=lambda *_: None)
    assert res["correct"]
    after = {p: p.read_bytes() for p in before}
    assert after == before            # no file the benchmark had was edited


def test_unknown_method_and_numbers_are_refused(tmp_path):
    root = _copy(tmp_path)
    bench_dir = root / "portbench"
    mix = json.loads((bench_dir / "traffic" / "fused-b1.json").read_text())
    (bench_dir / "traffic" / "flat-b1.json").write_text(json.dumps({**mix, "method": "fedavg"}))
    (bench_dir / "limits" / "iout10k-flat.json").write_text(
        (bench_dir / "limits" / "iout10k-fused.json").read_text())
    (bench_dir / "limits" / "iout10k-odd.json").write_text(json.dumps({"no_such_gap": 0.0}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"] += [{"name": "iout10k-flat", "config": "iout-10k", "traffic": "flat-b1",
                           "chips": 1, "why": "fedavg"},
                          {"name": "iout10k-odd", "config": "iout-10k", "traffic": "fused-b1",
                           "chips": 1, "why": "a number no module computes"}]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = harness.Bench(root, bench_dir)
    with pytest.raises(harness.UnknownName, match="fedavg"):
        bench.cell("iout10k-flat")
    with pytest.raises(harness.UnknownName, match="no_such_gap"):
        bench.cell("iout10k-odd")

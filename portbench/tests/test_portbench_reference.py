"""The reference against the port's CPU path, and the comparison that
decides ``correct`` against what it must catch: a whole run at a CPU size
comes out correct; the TF32 control in the program's place, and a run
with the timed path broken underneath, come out not correct."""
import copy

import pytest
import torch

from conftest import SEED, tiny
from portbench import check, control, harness
from portbench.program import Program

CPU = torch.device("cpu")
CELLS = [w["name"] for w in harness.Bench().spec["workloads"]]
# Knobs of the hfl-selective reference that no cell turns yet, each put on
# the first cell's mix: the paths the reference implements for later cells.
VARIANTS = {
    "batched": {"trials": 2},
    "chunked": {"client_chunk": 5},
    "byz": {"fog_reduce": "trimmed", "trim_frac": 0.45,
            "faults": {"byz_mode": "gauss", "byz_frac": 0.25, "byz_scale": 20.0,
                       "erasure_prob": 0.3, "crash_prob": 0.0}},
}
CASES = CELLS + [f"{CELLS[0]}+{v}" for v in VARIANTS]


def case(bench, name: str) -> harness.Cell:
    """A cell of ``BENCHMARK.json``, or one with a variant's knobs on its
    mix, cut to the CPU's size."""
    base, _, variant = name.partition("+")
    cell = bench.cell(base)
    if variant:
        cell = copy.deepcopy(cell)
        cell.mix.update(VARIANTS[variant])
        cell.method.check(cell.cfg, cell.mix)
    return tiny(cell)


def run(cell, bench, device=CPU):
    return harness.run(cell, bench, SEED, 0.3, False, device, Program, 0.0, log=lambda *_: None)


@pytest.mark.parametrize("name", CASES)
def test_reference_matches_the_ports_cpu_path(bench, name):
    cell = case(bench, name)
    trials = harness.draw(cell, SEED, CPU)
    prog = Program(cell.cfg, cell.mix, CPU)
    out = prog.call(prog.inputs(trials))
    ref, stacked_in = harness.reference(cell, trials)
    assert 0.3 < float(out["participation"].min())            # the tiny basin trains
    found, failed = harness.judge(cell, [out], ref, stacked_in)
    assert failed == 0
    assert found["physics_gap"] == 0.0 and found["eval_gap"] == 0.0
    assert found["loss_gap"] <= 1e-6 and found["change_gap"] <= 1e-5


@pytest.mark.parametrize("name", CASES)
def test_cpu_run_is_correct(bench, name):
    res = run(case(bench, name), bench)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"client_rounds_per_s", "trial_p95_ms", "peak_device_gib",
                                   "setup_s"}


@pytest.mark.parametrize("name", CASES)
def test_control_is_not_correct(bench, name):
    """The reference in TF32, put in the program's place, fails the cell's
    limits."""
    cell = case(bench, name)
    trials = harness.draw(cell, SEED, CPU)
    ref, stacked_in = harness.reference(cell, trials)
    found = control.stand_in(cell, trials, ref, stacked_in, "control")
    assert not check.verdict(found, cell.limits)


def _unchanged(monkeypatch):
    from repro_torch.core import hfl
    make = hfl.make_round_fn

    def frozen(*args, **kw):
        round_fn = make(*args, **kw)

        def step(state, *draws):
            _, metrics = round_fn(state, *draws)
            return state._replace(t=state.t + 1), metrics
        return step
    monkeypatch.setattr(hfl, "make_round_fn", frozen)


def _half(monkeypatch):
    from repro_torch.core import aggregation as agg
    for name in ("compress_and_aggregate", "robust_compress_and_aggregate"):
        fn = getattr(agg, name)

        def halved(deltas, err, fog_id, weights, *args, _fn=fn, **kw):
            keep = torch.arange(weights.shape[0], device=weights.device) % 2 == 0
            return _fn(deltas, err, fog_id, weights * keep, *args, **kw)
        monkeypatch.setattr(agg, name, halved)


def _altered(monkeypatch):
    from repro_torch.core import anomaly
    flag = anomaly.flag_anomalies

    def flipped(errors, tau):
        pred = flag(errors, tau).clone()
        pred[..., 0] = ~pred[..., 0]
        return pred
    monkeypatch.setattr(anomaly, "flag_anomalies", flipped)


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered], ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize("name", CASES)
def test_broken_timed_path_is_not_correct(bench, monkeypatch, name, fault):
    cell = case(bench, name)
    Program(cell.cfg, cell.mix, CPU)       # import the port first
    fault(monkeypatch)
    res = run(cell, bench)
    assert not res["correct"]


@pytest.mark.parametrize("knob, what", [
    ({"fog_reduce": "median"}, "fog_reduce"),
    ({"faults": {"byz_mode": "sign_flip", "byz_frac": 0.25, "byz_scale": 20.0,
                 "erasure_prob": 0.0, "crash_prob": 0.0}}, "byz_mode"),
    ({"drift": {"current_m_s": 3.0}}, "traffic key 'drift'"),
    ({"trim_frac": 0.45}, "trim_frac"),
    ({"rule": "nearest"}, "rule"),
])
def test_reference_refuses_what_it_does_not_implement(bench, knob, what):
    cell = bench.cell(CELLS[0])
    with pytest.raises(ValueError, match=what):
        cell.method.check(cell.cfg, {**cell.mix, **knob})


def test_reference_refuses_static_fogs(bench):
    cell = copy.deepcopy(bench.cell(CELLS[0]))
    cell.cfg["deployment"]["fog_mobility"] = False
    with pytest.raises(ValueError, match="fog_mobility"):
        cell.method.check(cell.cfg, cell.mix)


def test_unknown_method_is_refused():
    with pytest.raises(harness.UnknownName, match="fedavg"):
        harness.method_reference("fedavg")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_card_run_is_correct(bench, card, name):
    res = run(case(bench, name), bench, card)
    assert res["correct"], res["checks"]

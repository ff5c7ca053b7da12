"""Port parity for the event-driven async family (``core/async_fl``),
PyTorch vs JAX, at the quick size (12 sensors, 3 fogs, E = 1, at most 8
events).

* The sync limit: the port's ``async_fl.train(sync_limit(cfg))`` equals
  the port's ``hfl.train`` on the same draws (params rtol 1e-5 / atol
  1e-6, every ``RoundMetrics`` field rtol 1e-4 / atol 1e-6, every event
  merged, staleness 0), as ``tests/test_async_fl.py`` pins the reference.
* Against ``repro.core.async_fl.train`` on the reference's own draws
  (``test_torch_hfl.jax_inputs`` with ``rounds = n_events``: an event
  splits its key as a round does), event by event in five cells (the
  default, ``tau_max`` with ``timeout_s``, crash + erasure + Gaussian
  colluders at scale 5 under the trimmed reduce with ``client_chunk``,
  median with FedAdam and reassociating drift, a replayed (N,)
  ``arrival_delay_s``): ``merged``, ``n_launched``, ``n_arrived``,
  ``n_erased``, ``coop_links``, ``n_nonfinite`` and ``global_finite``
  exactly, participation as a count, every other field and the final
  params to the round pins' tolerance (rtol = atol = 1e-5).
* The reference file's behaviour tests, the neutral drift cell against
  drift off within that tolerance, and the family through
  ``trial_metrics`` / ``run_method`` and the batched ``Engine`` (trials
  (s, 0) against sequential trials, one trial's kernel routes per cell,
  sweeps' shape classes, audits refused).

The module runs on one torch intra-op thread, as ``test_torch_engine.py``
does.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_torch_hfl import N, TOL, data, jax_cfg, jax_inputs, torch_cfg  # noqa: F401
from torch_parity import one_intra_op_thread  # noqa: F401

from repro.core import async_fl as jaf
from repro.core import drift as jdrf
from repro.core import faults as jflt
from repro.models import autoencoder as jae
from repro_torch import engine as teng
from repro_torch.core import async_fl as taf
from repro_torch.core import drift as tdrf
from repro_torch.core import faults as tflt
from repro_torch.core import hfl as thfl
from repro_torch.kernels import ref as tref
from repro_torch.launch import experiment as texp
from repro_torch.models import autoencoder as tae

EXACT = ("merged", "n_launched", "n_arrived", "n_erased", "coop_links", "n_nonfinite",
         "global_finite")
COUNTERS = ("nonfinite_total", "erased_total", "nonfinite_rounds", "merges")
DELAYS = np.random.default_rng(0).permutation(np.linspace(0.5, 3.0, N)).astype(np.float32)


def _faults(mod):
    return mod.FaultConfig(crash_prob=0.2, erasure_prob=0.3, byz_frac=0.25, byz_scale=5.0,
                           byz_mode="gauss")


def _drift(mod):
    return mod.DriftConfig(sensor_current_m_s=3.0, reassoc_every=2.0)


# name -> (seed, round-config overrides in each package, async knobs)
CELLS = {
    "default": (0, lambda m: {}, dict(buffer_k=4.0, fog_k=1.0, alpha=0.5)),
    "tau_max timeout": (1, lambda m: {}, dict(buffer_k=6.0, fog_k=1.0, alpha=1.0, tau_max=1.0,
                                              timeout_s=0.5)),
    "faults trimmed chunk": (2, lambda m: dict(faults=_faults(m), robust="trimmed",
                                               trim_frac=0.2, client_chunk=5),
                             dict(buffer_k=4.0, fog_k=2.0, alpha=0.5)),
    "median adam drift": (3, lambda m: dict(robust="median", server_opt="adam", drift=_drift(m)),
                          dict(buffer_k=4.0, fog_k=1.0, alpha=0.5)),
    "replay": (4, lambda m: {}, dict(buffer_k=4.0, fog_k=2.0, alpha=0.5,
                                     arrival_delay_s=DELAYS)),
}
EVENTS = 8


def _torch_knobs(knobs):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in knobs.items()}


def port_cfg(name, n_events=EVENTS):
    _, over, knobs = CELLS[name]
    return taf.AsyncFLConfig(base=torch_cfg(**over(tflt if "faults" in name else tdrf)),
                             n_events=n_events, **_torch_knobs(knobs))


def _ref_cfg(name):
    _, over, knobs = CELLS[name]
    return jaf.AsyncFLConfig(base=jax_cfg(**over(jflt if "faults" in name else jdrf)),
                             n_events=EVENTS, **knobs)


@pytest.fixture(scope="module", params=list(CELLS))
def events_both(request, data):
    """One cell on the reference's draws in both packages: (name, the
    reference's metrics and flat params, the port's, and the port's
    inputs and dataset)."""
    ds, ds_t = data
    name = request.param
    acfg_j = _ref_cfg(name)
    key = jax.random.key(CELLS[name][0])
    params_j, inputs = jax_inputs(key, ds, acfg_j.base.replace(rounds=EVENTS))
    _, k_train = jax.random.split(key)
    p_j, m_j = jaf.train(k_train, params_j, jae.loss, ds, acfg_j)
    p_t, m_t = taf.train(inputs.params, tae.loss, ds_t, port_cfg(name), inputs.dep,
                         inputs.draws)
    flat_j = np.asarray(jax.flatten_util.ravel_pytree(p_j)[0])
    return name, m_j, flat_j, m_t, tae.ravel(p_t).numpy(), (inputs, ds_t)


def test_events_match_the_reference(events_both):
    name, m_j, flat_j, m_t, flat_t, _ = events_both
    for field in taf.AsyncEventMetrics._fields:
        got, want = getattr(m_t, field).numpy(), np.asarray(getattr(m_j, field))
        assert got.shape == want.shape == (EVENTS,), field
        if field in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=f"{name}: {field}")
        elif field == "participation":
            np.testing.assert_array_equal(np.round(got * N), np.round(want * N), err_msg=name)
        else:
            np.testing.assert_allclose(got, want, **TOL, err_msg=f"{name}: {field}")
    np.testing.assert_allclose(flat_t, flat_j, **TOL, err_msg=name)


def test_cells_exercise_what_they_name(events_both):
    """Each cell reaches its own path: merges and holds, stale arrivals,
    erasures and crashes in the fault cell, the replayed clock."""
    name, _, _, m_t, _, (inputs, ds_t) = events_both
    merged = m_t.merged.numpy()
    assert merged.any() and not merged.all(), name
    assert float(m_t.staleness.max()) > 0.0, name
    if name == "faults trimmed chunk":
        assert int(m_t.n_erased.sum()) > 0 and int(m_t.n_launched.sum()) < N * EVENTS
    if name == "replay":
        # The replayed delays replace the physics clock.
        _, m_phys = taf.train(inputs.params, tae.loss, ds_t, port_cfg(name).replace(
            arrival_delay_s=0.0), inputs.dep, inputs.draws)
        assert not np.allclose(m_phys.t_sim.numpy(), m_t.t_sim.numpy())


def test_config_mirrors_the_reference():
    ref = {f.name: f.default for f in dataclasses.fields(jaf.AsyncFLConfig)}
    got = {f.name: f.default for f in dataclasses.fields(taf.AsyncFLConfig)}
    assert set(got) == set(ref)
    assert {k: v for k, v in got.items() if k != "base"} == {
        k: v for k, v in ref.items() if k != "base"}
    assert taf.NEVER_S == jaf.NEVER_S
    s_t, s_j = taf.sync_limit(torch_cfg()), jaf.sync_limit(jax_cfg())
    for f in ("n_events", "buffer_k", "fog_k", "alpha", "timeout_s", "fog_timeout_s", "tau_max"):
        assert getattr(s_t, f) == getattr(s_j, f), f


def _port_events(ds_t, acfg, seed=0):
    """``acfg``'s trial in the port on draws from seed ``seed``: (the
    final state, the metrics)."""
    inputs = texp.draw_trial(torch.Generator().manual_seed(seed), ds_t, acfg, method="hfl-async")
    state = taf.init_state(inputs.params, inputs.dep, acfg)
    event_fn, per_event = taf.make_event_fn(tae.loss, ds_t, acfg), []
    for t in range(acfg.n_events):
        state, m = event_fn(state, *inputs.draws.round(t))
        per_event.append(m)
    return state, thfl.stack_metrics(per_event)


def test_sync_limit_reproduces_hfl_train(data):
    _, ds_t = data
    cfg = torch_cfg(rounds=3)
    inputs = texp.draw_trial(torch.Generator().manual_seed(5), ds_t, cfg)
    p_s, m_s = thfl.train(inputs.params, tae.loss, ds_t, cfg, inputs.dep, inputs.draws)
    p_a, m_a = taf.train(inputs.params, tae.loss, ds_t, taf.sync_limit(cfg), inputs.dep,
                         inputs.draws)
    np.testing.assert_allclose(tae.ravel(p_a).numpy(), tae.ravel(p_s).numpy(), rtol=1e-5,
                               atol=1e-6)
    for field in thfl.RoundMetrics._fields:
        np.testing.assert_allclose(getattr(m_a, field).numpy(), getattr(m_s, field).numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=field)
    assert bool(m_a.merged.all())
    np.testing.assert_array_equal(m_a.staleness.numpy(), 0.0)


def test_sync_limit_through_run_method(data):
    _, ds_t = data
    cfg = torch_cfg(rounds=2)
    r_sync = texp.run_method("hfl-selective", ds_t, cfg, seed=3, device="cpu")
    r_async = texp.run_method("hfl-async", ds_t, taf.sync_limit(cfg), seed=3, device="cpu")
    assert r_async.f1 == pytest.approx(r_sync.f1, abs=1e-6)
    assert r_async.e_total == pytest.approx(r_sync.e_total, rel=1e-4)
    np.testing.assert_allclose(r_async.losses, r_sync.losses, rtol=1e-4)


def test_version_advances_only_on_effective_merges(data):
    _, ds_t = data
    final, m = _port_events(ds_t, port_cfg("default", n_events=12), seed=4)
    n_merges = int(m.merged.sum())
    assert 0 < int(final.version) <= n_merges
    assert float(m.staleness.max()) <= float(final.version)
    t = m.t_sim.numpy()
    assert np.all(np.isfinite(t)) and np.all(np.diff(t) >= 0.0)


def test_fog_cadence_decoupled_from_global(data):
    _, ds_t = data
    _, fast = _port_events(ds_t, port_cfg("default").replace(fog_k=1.0), seed=6)
    _, slow = _port_events(ds_t, port_cfg("default").replace(fog_k=6.0), seed=6)
    assert float(slow.n_arrived.float().mean()) > float(fast.n_arrived.float().mean())
    assert bool(fast.merged.any()) and bool(slow.merged.any())


def test_timeout_forces_merge(data):
    _, ds_t = data
    _, m = _port_events(ds_t, port_cfg("default", n_events=6).replace(buffer_k=1e6,
                                                                       timeout_s=1e-3), seed=9)
    assert bool(m.merged.all())


def test_async_beats_sync_limit_on_event_time(data):
    _, ds_t = data
    base = torch_cfg(rounds=3)
    _, m_sync = _port_events(ds_t, taf.sync_limit(base), seed=8)
    _, m_async = _port_events(ds_t, taf.AsyncFLConfig(base=base, n_events=9, buffer_k=4.0,
                                                      fog_k=1.0, alpha=0.5), seed=8)

    def per_merge(m):
        return float(m.t_sim[-1]) / max(float(m.merged.float().sum()), 1.0)
    assert per_merge(m_async) < per_merge(m_sync)


def test_tau_max_drops_stale_updates(data):
    _, ds_t = data
    acfg = port_cfg("default", n_events=10).replace(alpha=1.0)
    _, m_disc = _port_events(ds_t, acfg, seed=13)
    assert float(m_disc.staleness.max()) > 0.0
    _, m_never = _port_events(ds_t, acfg.replace(tau_max=1e20), seed=13)
    np.testing.assert_array_equal(m_disc.loss.numpy(), m_never.loss.numpy())
    _, m_drop = _port_events(ds_t, acfg.replace(tau_max=0.0), seed=13)
    assert bool(m_drop.global_finite.all())
    assert not np.allclose(m_drop.loss.numpy(), m_disc.loss.numpy())


def test_neutral_drift_matches_drift_off(data):
    """Active drift at zero rates takes the drift code path; it equals the
    drift-off run within the round pins' tolerance (the reference's own
    bit-identity pin misses by 3.7e-9 under this jax)."""
    _, ds_t = data
    acfg = port_cfg("default", n_events=6)
    on = acfg.replace(base=acfg.base.replace(drift=tdrf.DriftConfig(active=True)))
    _, m_off = _port_events(ds_t, acfg, seed=5)
    _, m_on = _port_events(ds_t, on, seed=5)
    for field in taf.AsyncEventMetrics._fields:
        np.testing.assert_allclose(getattr(m_on, field).numpy(), getattr(m_off, field).numpy(),
                                   **TOL, err_msg=field)
    np.testing.assert_array_equal(m_on.participation.numpy(), m_off.participation.numpy())
    np.testing.assert_array_equal(m_on.merged.numpy(), m_off.merged.numpy())


def test_draws_cover_the_events_and_the_mesh_raises(data):
    _, ds_t = data
    acfg = port_cfg("default")
    inputs = texp.draw_trial(torch.Generator().manual_seed(0), ds_t, acfg, method="hfl-async")
    assert inputs.draws.mobility.shape[0] == EVENTS
    # A plain HFLConfig is wrapped with the async defaults (40 events).
    plain = texp.draw_trial(torch.Generator().manual_seed(0), ds_t, torch_cfg(),
                            method="hfl-async")
    assert plain.draws.batches.shape[0] == taf.AsyncFLConfig().n_events
    short = inputs._replace(draws=thfl.RoundDraws(*(x[:3] for x in inputs.draws if x is not None)))
    with pytest.raises(ValueError, match="draws cover"):
        texp.trial_metrics("hfl-async", None, ds_t, acfg, inputs=short, device="cpu")
    # The client mesh raised until queue-1 item 15 was ported; the async
    # family runs whole on every rank and ignores it, as the reference's.
    sharded = texp.trial_metrics("hfl-async", None, ds_t, acfg, inputs=inputs,
                                 client_mesh=object(), device="cpu")
    whole = texp.trial_metrics("hfl-async", None, ds_t, acfg, inputs=inputs, device="cpu")
    for k, v in whole.items():
        assert torch.equal(sharded[k], v), k


# --- the batched Engine -----------------------------------------------------

def _assert_trial(got, want, what, events):
    for name in COUNTERS + ("coop_links",):
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(),
                                      err_msg=f"{what}: {name}")
    np.testing.assert_array_equal(np.round(got["participation"].numpy() * N * events),
                                  np.round(want["participation"].numpy() * N * events),
                                  err_msg=what)
    for name in ("e_total", "e_s2f", "e_f2f", "e_f2g", "sim_time_s", "staleness"):
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=1e-5, atol=1e-9,
                                   err_msg=f"{what}: {name}")
    np.testing.assert_allclose(got["losses"].numpy(), want["losses"].numpy(), rtol=1e-4,
                               err_msg=f"{what}: losses")
    for name in ("f1", "precision", "recall"):
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=1e-3,
                                   err_msg=f"{what}: {name}")


def _run_vs_sequential(ds_t, acfg, seeds, columns=(0,), p=2):
    eng = teng.Engine(device="cpu")
    run = eng.run("hfl-async", acfg, seeds, ds_t, n_deployments=p)
    rcfg = eng.resolve_config(acfg)
    for s, seed in enumerate(seeds):
        g = torch.Generator().manual_seed(seed)
        for j in range(max(columns) + 1):
            inputs = texp.draw_trial(g, ds_t, rcfg, method="hfl-async")
            if j in columns:
                want = texp.trial_metrics("hfl-async", None, ds_t, rcfg, inputs=inputs,
                                          device="cpu")
                _assert_trial({k: v[s, j] for k, v in run.metrics.items()}, want,
                              f"trial ({seed}, {j})", rcfg.n_events)
    return run


def test_engine_run_trials_equal_sequential_trials(data):
    _, ds_t = data
    run = _run_vs_sequential(ds_t, port_cfg("default"), (0, 1), columns=(0, 1))
    assert run.f1.shape == (2, 2) and run.losses.shape == (2, 2, EVENTS)
    assert {"merges", "staleness", "sim_time_s"} <= set(run.metrics)
    assert len(np.unique(run["e_s2f"].numpy())) == 4


@pytest.mark.parametrize("name", [c for c in CELLS if c != "default"])
def test_engine_batched_equals_sequential_in_every_cell(data, name):
    _, ds_t = data
    run = _run_vs_sequential(ds_t, port_cfg(name), (7,))
    if name == "faults trimmed chunk":
        assert float(run["erased_total"].sum()) > 0


@pytest.mark.parametrize("name", ["default", "median adam drift"])
def test_a_cell_calls_each_kernel_route_as_one_trial_does(data, monkeypatch, name):
    """S * P trials' events fold into one call of each kernel's route an
    event: the plain versions here, the kernels on the card."""
    _, ds_t = data
    routes = ("local_train_ref", "compress_aggregate_ref", "robust_aggregate_ref")
    calls = dict.fromkeys(routes, 0)
    for attr in routes:
        def counted(*a, _fn=getattr(tref, attr), _name=attr, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tref, attr, counted)
    per_cell = {}
    for seeds, p in (((0,), 1), ((0, 1, 2), 2)):
        calls.update(dict.fromkeys(routes, 0))
        teng.Engine(device="cpu").run("hfl-async", port_cfg(name), seeds, ds_t, n_deployments=p)
        per_cell[len(seeds) * p] = dict(calls)
    robust = EVENTS if name != "default" else 0
    assert per_cell[1] == per_cell[6] == {"local_train_ref": EVENTS,
                                          "compress_aggregate_ref": EVENTS,
                                          "robust_aggregate_ref": robust}


def test_sweep_alpha_by_buffer_is_one_class(data):
    _, ds_t = data
    eng = teng.Engine(device="cpu")
    base = port_cfg("default", n_events=6)
    cfgs = [base.replace(alpha=a, buffer_k=k) for a in (0.0, 0.5) for k in (3.0, 6.0)]
    sw = eng.sweep("hfl-async", cfgs, (0, 1), ds_t)
    assert sw.n_classes == 1 and sw.compiled_programs == 1
    assert sw.classes[0]["knobs"] == ["alpha", "buffer_k"]
    for i in (0, 3):
        r = eng.run("hfl-async", cfgs[i], (0, 1), ds_t)
        for key in ("f1", "sim_time_s", "merges", "staleness", "losses"):
            np.testing.assert_array_equal(sw[key][i].numpy(), r[key].numpy(), err_msg=key)


def test_a_replay_cell_forms_its_own_class(data):
    _, ds_t = data
    eng = teng.Engine(device="cpu")
    plain, replay = port_cfg("default", n_events=4), port_cfg("replay", n_events=4)
    other = replay.replace(arrival_delay_s=replay.arrival_delay_s.flip(0))
    sw = eng.sweep("hfl-async", [plain, replay, other], (0,), ds_t)
    assert sw.n_classes == 2
    assert sorted(c["indices"] for c in sw.classes) == [(0,), (1, 2)]
    assert [c["knobs"] for c in sw.classes if c["indices"] == (1, 2)] == [["arrival_delay_s"]]
    assert not np.array_equal(sw["sim_time_s"][1].numpy(), sw["sim_time_s"][2].numpy())
    # The run cache keys a tensor leaf by its bytes: equal bytes hit it.
    before = eng.compile_count
    eng.run("hfl-async", replay, (0,), ds_t)
    eng.run("hfl-async", replay.replace(arrival_delay_s=replay.arrival_delay_s.clone()),
            (0,), ds_t)
    eng.run("hfl-async", other, (0,), ds_t)
    assert eng.compile_count == before + 2


def test_audit_of_an_async_cell_raises():
    eng = teng.Engine(device="cpu")
    with pytest.raises(ValueError, match="audit"):
        eng.audit("hfl-selective", port_cfg("default"), (0,))
    with pytest.raises(ValueError, match="audit"):
        eng.sweep("hfl-selective", [port_cfg("default")], (0,), family="audit")
    assert eng.resolve_config(port_cfg("default")).base == eng.resolve_config(
        port_cfg("default").base)

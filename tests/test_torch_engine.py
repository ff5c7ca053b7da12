"""The port's batched trial engine (``repro_torch.engine``) on the CPU.

* Against the reference: ``repro.engine.Engine().run`` for
  ``hfl-selective`` and ``fedavg`` over seeds (0, 1) x 2 deployments, and
  the port's batched trial function (``experiment.batched_trial_metrics``)
  fed the reference's own draws for each of its trial keys
  (``Engine._trial_keys`` through ``test_torch_hfl.jax_inputs``); one
  dataset (the port's) goes to both.  Counters exactly, every other
  metric to ``test_torch_hfl.TOL`` (rtol = atol = 1e-5).
* Batched against sequential in the port: trial (s, 0) of an
  ``Engine.run`` cell equals ``experiment.trial_metrics`` drawn from
  ``torch.Generator().manual_seed(s)`` (and trial (s, 1) the next trial
  drawn from that generator), for every ported method and under faults,
  drift, client chunks and the per-client compressor: counters,
  participation and coop links exactly, energies to rtol 1e-5, losses to
  rtol 1e-4, F1 to atol 1e-3 (the reference's ``tests/test_engine.py``
  tolerances; the batched trials sum the same values in other orders).
* A cell of any S * P calls each kernel's route (here its plain version)
  as often as one trial does; with ``client_chunk`` the wire pair's route
  ceil(B * N / chunk) times a round.
* ``audit``, ``reachability``, ``sweep``, ``score``, ``store=`` and the
  program cache; the two ``NotImplementedError``s left (``hfl-async``,
  which raised a third, now runs).
* ``ref.local_train_ref`` with a per-trial start (w (B, ...)) against
  ``jax.vmap`` of the reference's local-train oracle over the trials.
"""
import jax
import numpy as np
import pytest
import torch
from torch_parity import one_intra_op_thread  # noqa: F401

from repro import engine as jeng
from repro.kernels import ops as jops
from repro_torch import engine as teng
from repro_torch.checkpoint import CheckpointStore
from repro_torch.core import channel as tch
from repro_torch.core import compression as tcomp
from repro_torch.core.async_fl import AsyncFLConfig
from repro_torch.core import participation as tpart
from repro_torch.core import topology as ttopo
from repro_torch.core.drift import DriftConfig
from repro_torch.core.faults import FaultConfig
from repro_torch.kernels import ref as tref
from repro_torch.launch import experiment as texp
from repro_torch.models import autoencoder as tae
from repro_torch.serving.score import score as serving_score
from test_torch_hfl import HFL_METHODS, TOL, T, data, jax_cfg, jax_inputs, torch_cfg  # noqa: F401

SEEDS = (0, 1)
P = 2
COUNTERS = ("nonfinite_total", "erased_total", "nonfinite_rounds")
PORTED = HFL_METHODS + ("fedavg", "fedprox", "fedadam", "scaffold", "centralised")


def _cpu_engine(**kw):
    return teng.Engine(device="cpu", **kw)


# --- against the reference's Engine -----------------------------------------

@pytest.fixture(scope="module", params=["hfl-selective", "fedavg"])
def against_reference(request, data):
    ds, ds_t = data
    method = request.param
    eng = jeng.Engine()
    cfg_j = jax_cfg()
    ref = eng.run(method, cfg_j, SEEDS, ds, n_deployments=P)
    rcfg = eng.resolve_config(cfg_j)
    keys = eng._trial_keys(SEEDS, P)
    inputs = [jax_inputs(keys[s, j], ds, rcfg)[1] for s in range(len(SEEDS)) for j in range(P)]
    got = texp.batched_trial_metrics(method, inputs, ds_t, torch_cfg(), device="cpu")
    return method, ref, got


def test_batched_trials_match_the_reference_engine(against_reference):
    _, ref, got = against_reference
    assert set(got) == set(ref.metrics)
    for name, v in got.items():
        want = np.asarray(ref[name])
        v = v.numpy().reshape(want.shape)
        if name in COUNTERS or name == "coop_links":
            np.testing.assert_array_equal(v, want, err_msg=name)
        else:
            np.testing.assert_allclose(v, want, **TOL, err_msg=name)


def test_reference_engine_trials_are_distinct(against_reference):
    _, ref, got = against_reference
    e = got["e_total"].numpy()
    assert len(np.unique(e)) == e.size          # every (seed, deployment) its own world


# --- batched against sequential in the port ---------------------------------

def _assert_trial(got, want, what):
    for name in COUNTERS + ("coop_links",):
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(),
                                      err_msg=f"{what}: {name}")
    np.testing.assert_array_equal(np.round(got["participation"].numpy() * 12),
                                  np.round(want["participation"].numpy() * 12), err_msg=what)
    for name in ("e_total", "e_s2f", "e_f2f", "e_f2g", "sim_time_s"):
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=1e-5, atol=1e-9,
                                   err_msg=f"{what}: {name}")
    np.testing.assert_allclose(got["losses"].numpy(), want["losses"].numpy(), rtol=1e-4,
                               err_msg=f"{what}: losses")
    for name in ("f1", "precision", "recall"):
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=1e-3,
                                   err_msg=f"{what}: {name}")


def _run_vs_sequential(ds_t, method, cfg, seeds=SEEDS, columns=(0,)):
    """An (S, P = 2) cell against sequential trials at ``columns``."""
    eng = _cpu_engine()
    run = eng.run(method, cfg, seeds, ds_t, n_deployments=P)
    rcfg = eng.resolve_config(cfg)
    for s, seed in enumerate(seeds):
        g = torch.Generator().manual_seed(seed)
        for j in range(max(columns) + 1):
            inputs = texp.draw_trial(g, ds_t, rcfg, method=method)
            if j in columns:
                want = texp.trial_metrics(method, None, ds_t, rcfg, inputs=inputs,
                                          device="cpu")
                _assert_trial({k: v[s, j] for k, v in run.metrics.items()}, want,
                              f"{method} trial ({seed}, {j})")
    return run


@pytest.mark.parametrize("method", PORTED)
def test_run_trials_equal_sequential_trials(data, method):
    _, ds_t = data
    run = _run_vs_sequential(ds_t, method, torch_cfg())
    assert run.f1.shape == (len(SEEDS), P) and run.losses.shape[:2] == (len(SEEDS), P)
    # Every (seed, deployment) its own world.
    assert len(np.unique(run["e_s2f"].numpy())) == len(SEEDS) * P or method == "centralised"


def test_later_deployment_columns_continue_the_seed_stream(data):
    _, ds_t = data
    _run_vs_sequential(ds_t, "hfl-selective", torch_cfg(), seeds=(3,), columns=(1,))


FAULTS = FaultConfig(byz_mode="gauss", byz_frac=0.25, byz_scale=5.0, erasure_prob=0.3)
VARIANTS = {
    "faults trimmed": dict(faults=FAULTS, robust="trimmed", trim_frac=0.2),
    "drift reassoc": dict(drift=DriftConfig(sensor_current_m_s=3.0, reassoc_every=2.0)),
    "client chunk": dict(client_chunk=5),
    "per-client compressor": dict(compressor=tcomp.CompressorConfig(fused=False)),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("method", ["hfl-selective", "fedavg"])
def test_run_trials_equal_sequential_under_options(data, variant, method):
    _, ds_t = data
    run = _run_vs_sequential(ds_t, method, torch_cfg(**VARIANTS[variant]), seeds=(4,))
    if variant == "faults trimmed":
        assert float(run["erased_total"].sum()) > 0


def test_a_cell_calls_each_kernel_route_as_one_trial_does(data, monkeypatch):
    """S * P trials fold into one call of each kernel's route a round: the
    plain versions here, the kernels on the card (``chip_smoke.py`` phase
    18, ``test_torch_cuda.py``)."""
    _, ds_t = data
    calls = {"local_train": 0, "compress_aggregate": 0}
    for name, attr in (("local_train", "local_train_ref"),
                       ("compress_aggregate", "compress_aggregate_ref")):
        fn = getattr(tref, attr)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tref, attr, counted)
    per_cell = {}
    for seeds, p in (((0,), 1), ((0, 1, 2), 2)):
        for k in calls:
            calls[k] = 0
        _cpu_engine().run("hfl-selective", torch_cfg(), seeds, ds_t, n_deployments=p)
        per_cell[len(seeds) * p] = dict(calls)
    assert per_cell[1] == per_cell[6] == {"local_train": T, "compress_aggregate": T}


def test_a_chunked_cell_walks_its_folded_clients_in_chunks(data, monkeypatch):
    """With ``client_chunk`` the wire pair walks the B * N folded clients a
    chunk at a time: ceil(B * N / chunk) calls of each a round, while the
    local-train route stays at one call a round."""
    _, ds_t = data
    cfg = torch_cfg(client_chunk=5)
    n = cfg.deployment.n_sensors
    calls = dict.fromkeys(("local_train", "compress_wire", "wire_aggregate"), 0)
    for name in calls:
        fn = getattr(tref, f"{name}_ref")

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tref, f"{name}_ref", counted)
    for seeds, p in (((0,), 1), ((0, 1, 2), 2)):
        for k in calls:
            calls[k] = 0
        _cpu_engine().run("hfl-selective", cfg, seeds, ds_t, n_deployments=p)
        chunks = -(-len(seeds) * p * n // 5)
        assert calls == {"local_train": T, "compress_wire": T * chunks,
                         "wire_aggregate": T * chunks}, (seeds, p)


def test_trial_keys_and_program_cache(data):
    _, ds_t = data
    assert teng.Engine._trial_keys((3, 5), 2) == (((3, 0), (3, 1)), ((5, 0), (5, 1)))
    with pytest.raises(ValueError):
        teng.Engine._trial_keys((), 1)
    eng = _cpu_engine()
    r1 = eng.run("hfl-nocoop", torch_cfg(), SEEDS, ds_t)
    r2 = eng.run("hfl-nocoop", torch_cfg(), SEEDS, lambda s: ds_t)
    assert r1.fresh_compile and not r2.fresh_compile and eng.compile_count == 1
    np.testing.assert_array_equal(r1.f1.numpy(), r2.f1.numpy())
    log = eng.take_log()
    assert [e["fresh_compile"] for e in log] == [True, False]
    assert log[0]["batched"] and log[0]["n_trials"] == 2 and log[0]["launches"] == {}
    assert eng.take_log() == []
    mean, std = r1.seed_mean_std("e_total")
    assert mean > 0 and std >= 0


def test_engine_resolves_global_compressor_to_blockwise():
    eng = _cpu_engine()
    g = tcomp.CompressorConfig(mode="global", rho_s=0.05, quant_bits=8)
    assert eng.resolve_compressor(g) == g.replace(mode="blockwise")
    dense = tcomp.CompressorConfig(rho_s=1.0, quant_bits=32)
    assert eng.resolve_compressor(dense) == dense
    assert _cpu_engine(compressor="keep").resolve_compressor(g) == g
    assert _cpu_engine(client_chunk=4).resolve_config(torch_cfg()).client_chunk == 4
    assert _cpu_engine(client_chunk=4).resolve_config(torch_cfg(client_chunk=6)).client_chunk == 6


def test_store_publishes_the_first_trial(data, tmp_path):
    _, ds_t = data
    store = CheckpointStore(str(tmp_path), keep=2)
    run = _cpu_engine().run("hfl-selective", torch_cfg(), SEEDS, ds_t, n_deployments=P,
                            store=store)
    assert "params" not in run.metrics and store.latest_step() == T
    want = texp.trial_metrics("hfl-selective", torch.Generator().manual_seed(SEEDS[0]), ds_t,
                              torch_cfg(), device="cpu", return_params=True)["params"]
    loaded, _ = store.latest(want)
    np.testing.assert_allclose(tae.ravel(loaded).numpy(), tae.ravel(want).numpy(),
                               rtol=1e-4, atol=1e-6)


# --- audit, reachability, sweep, score ---------------------------------------

@pytest.mark.parametrize("method", HFL_METHODS + ("fedavg",))
def test_audit_trials_equal_audit_method(method):
    cfg = texp.make_config(60, 6, 4)
    out = _cpu_engine().audit(method, cfg, SEEDS, n_deployments=P)
    for s, seed in enumerate(SEEDS):
        want = texp.audit_method(method, cfg, seed=seed, device="cpu")
        for k in ("e_s2f", "e_f2f", "e_f2g", "e_total", "participation", "coop_links"):
            np.testing.assert_allclose(float(out[k][s, 0]), want[k], rtol=1e-5, atol=1e-9,
                                       err_msg=k)
    assert out["e_total"][0, 0] != out["e_total"][0, 1]


def test_reachability_trials_equal_the_sequential_study():
    cfg = texp.make_config(200, 20, 1)
    out = _cpu_engine().reachability(cfg, SEEDS, n_deployments=P)
    for s, seed in enumerate(SEEDS):
        g = torch.Generator().manual_seed(seed)
        for j in range(P):
            dep = ttopo.sample_deployment(g, cfg.deployment, device="cpu")
            want = tpart.reachability(dep, cfg.channel)
            for k in ("direct_gateway", "fog_assisted", "fog_to_gateway"):
                assert float(out[k][s, j]) == float(getattr(want, k)), k
    assert 0.2 < float(out["direct_gateway"].mean()) < 0.8


def test_participation_helpers():
    mask = torch.tensor([[True, False, True, True], [False, False, False, False]])
    np.testing.assert_allclose(tpart.participation_fraction(mask).numpy(), [0.75, 0.0])
    np.testing.assert_allclose(
        tpart.energy_per_participant(torch.tensor([6.0, 2.0]), mask).numpy(), [2.0, 2.0])


def test_sweep_classes_and_cells_equal_run(data):
    """A channel knob co-batches (one call over both cells' trials); an
    ``lr`` cell forms its own class, as on the reference's kernel backend
    (``local_train_f32`` takes ``lr`` as a scalar); a round count splits.
    Folding leaves each trial's arithmetic as it was, so every cell equals
    its ``Engine.run`` bit for bit."""
    _, ds_t = data
    cfgs = [torch_cfg(), torch_cfg(channel=tch.ChannelParams(wind_m_s=8.0)),
            torch_cfg(rounds=2), torch_cfg(lr=0.02)]
    eng = _cpu_engine()
    sw = eng.sweep("hfl-selective", cfgs, SEEDS, ds_t, n_deployments=P)
    assert sw.n_classes == 3 and sw.compiled_programs == 3
    assert [c["indices"] for c in sw.classes] == [(0, 1), (2,), (3,)]
    assert sw.classes[0]["knobs"] == ["channel.wind_m_s"]
    assert isinstance(sw["losses"], tuple) and sw["f1"].shape == (4, len(SEEDS), P)
    for i, cfg in enumerate(cfgs):
        run = eng.run("hfl-selective", cfg, SEEDS, ds_t, n_deployments=P)
        for k, v in run.metrics.items():
            np.testing.assert_array_equal(sw.cell(i)[k].numpy(), v.numpy(), err_msg=k)
    stacked = teng.Engine.stack_configs(cfgs[:2])
    np.testing.assert_allclose(stacked["channel.wind_m_s"].numpy(), [5.0, 8.0])
    np.testing.assert_allclose(stacked["lr"].numpy(), [0.01, 0.01])


def test_audit_sweep_takes_a_method_per_cell():
    cfgs = [texp.make_config(60, 6, 3), texp.make_config(60, 6, 3)]
    eng = _cpu_engine()
    sw = eng.sweep(["hfl-selective", "fedavg"], cfgs, SEEDS, family="audit")
    assert sw.n_classes == 1 and sw["e_total"].shape == (2, len(SEEDS), 1)
    for i, method in enumerate(("hfl-selective", "fedavg")):
        want = eng.audit(method, cfgs[i], SEEDS)
        np.testing.assert_array_equal(sw.cell(i)["e_total"].numpy(), want["e_total"].numpy())
    with pytest.raises(ValueError):
        eng.sweep(["hfl-selective", "fedavg"], cfgs, SEEDS, None, family="run")


def test_score_one_launch_or_one_per_trial(monkeypatch):
    calls = []
    fn = tref.fused_score_ref
    monkeypatch.setattr(tref, "fused_score_ref", lambda *a: calls.append(1) or fn(*a))
    g = torch.Generator().manual_seed(3)
    params = tae.init(g, 32, device="cpu")
    x = torch.randn((4, 10, 32), generator=g)
    eng = _cpu_engine()
    out = eng.score(params, x, 30.0)
    assert len(calls) == 1
    want = serving_score(params, x, 30.0)
    np.testing.assert_array_equal(out.error.numpy(), want.error.numpy())
    grid = [[tae.init(g, 32, device="cpu") for _ in range(2)] for _ in range(2)]
    stacked = [{k: torch.stack([torch.stack([grid[s][j][i][k] for j in range(2)])
                                for s in range(2)]) for k in ("w", "b")} for i in range(4)]
    xs = torch.randn((2, 2, 5, 32), generator=g)
    calls.clear()
    out = eng.score(stacked, xs, 30.0, n_trial_axes=2)
    assert len(calls) == 4 and out.flag.shape == (2, 2, 5)
    assert [e["batched"] for e in eng.take_log()] == [True, False]
    for s in range(2):
        for j in range(2):
            want = serving_score(grid[s][j], xs[s, j], 30.0)
            np.testing.assert_array_equal(out.error[s, j].numpy(), want.error.numpy())


def test_unported_paths_raise(data, monkeypatch):
    """``hfl-async`` raised until its queue-1 item 13 was ported; it now
    runs batched (``tests/test_torch_async.py`` holds it).  Sharding with
    several devices visible raised until queue-1 item 15's federated half
    was ported: without a process group the engine now runs on its one
    device and shards nothing (``tests/test_torch_mesh.py`` runs it
    sharded).  ``pod_train_step`` raised until queue-1 item 15's pod family
    was ported: it now runs one pod on the CPU (``tests/test_torch_pod.py``
    holds it against the reference)."""
    from repro_torch import configs as tconfigs
    from repro_torch.core import mesh_fl
    from repro_torch.models import api as tapi

    _, ds_t = data
    eng = _cpu_engine()
    run = eng.run("hfl-async", AsyncFLConfig(base=torch_cfg(), n_events=4), SEEDS, ds_t)
    assert run.losses.shape == (len(SEEDS), 1, 4) and eng.take_log()[0]["batched"]
    lm = tconfigs.get("llama3-8b", reduced=True)
    params = tapi.init_params(torch.Generator().manual_seed(0), lm)
    new, err, loss = eng.pod_train_step(lm)(
        params, mesh_fl.init_err(params, 1),
        {"tokens": torch.randint(0, lm.vocab_size, (2, 8), generator=torch.Generator())})
    assert bool(torch.isfinite(loss)) and type(new) is type(params)
    assert err.embed.shape == (1,) + tuple(params.embed.shape)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    sharding = _cpu_engine(shard_trials=True, shard_clients=True)
    run = sharding.run("hfl-selective", torch_cfg(), SEEDS, ds_t)
    assert run.losses.shape == (len(SEEDS), 1, T)
    (entry,) = sharding.take_log()
    assert not entry["client_sharded"] and not entry["trial_sharded"]


# --- the kernel's plain version with a start point per trial -----------------

@pytest.mark.parametrize("mu", [0.0, 0.01])
def test_local_train_ref_per_trial_start_matches_jax_vmap(mu):
    rng = np.random.default_rng(7)
    b_n, n, window, d, bs, steps = 3, 4, 64, 32, 32, 4
    dims = (d, 16, 8, 16, d)
    params = [{"w": (rng.standard_normal((b_n, a, c)) * 0.3).astype(np.float32),
               "b": (rng.standard_normal((b_n, c)) * 0.1).astype(np.float32)}
              for a, c in zip(dims[:-1], dims[1:])]
    x = rng.standard_normal((b_n, n, window, d)).astype(np.float32)
    idx = rng.integers(0, window, (b_n, n, steps, bs)).astype(np.int32)
    d_j, l_j = jax.vmap(lambda p, xx, ii: jops.local_train(p, xx, ii, 0.05, mu))(params, x, idx)
    d_t, l_t = tref.local_train_ref(
        torch.from_numpy(x.reshape(b_n * n, window, d)),
        torch.from_numpy(idx.reshape(b_n * n, steps, bs)),
        tuple(torch.from_numpy(p["w"]) for p in params),
        tuple(torch.from_numpy(p["b"]) for p in params), 0.05, mu)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j).reshape(b_n * n, -1),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j).reshape(-1), rtol=1e-5)
    # Trial b's clients are bitwise those of a call with trial b alone.
    for b in range(b_n):
        d_b, _ = tref.local_train_ref(
            torch.from_numpy(x[b]), torch.from_numpy(idx[b]),
            tuple(torch.from_numpy(p["w"][b]) for p in params),
            tuple(torch.from_numpy(p["b"][b]) for p in params), 0.05, mu)
        np.testing.assert_array_equal(d_t.numpy()[b * n:(b + 1) * n], d_b.numpy())

"""``Engine.sweep`` runs each shape class as one batched call, against the
JAX package and against the port's own ``Engine.run``.

* Per-trial knobs: cells that differ in channel, energy,
  ``compute_rate_flops``, the fault probabilities and the drift knobs
  (``reassoc_every`` 1 and 2) fold into one ``hfl.train_trials`` call with
  (B,) knobs; each folded trial equals the reference's ``hfl.train`` of
  its cell on the same injected draws (``jax_inputs`` of
  ``test_torch_hfl``), at the round pins' tolerances.  ``server_lr`` is
  held per trial against the reference's FedAdam step on the same
  pseudo-gradients, and the folded ``hfl-adam`` cells (``server_lr`` x
  ``compute_rate_flops``) against the reference's ``hfl.train`` of each
  cell as the other knobs' cells are.
* Classes: the port's ``Engine._sweep_classes`` groups
  ``tests/test_sweep.py``'s grids as the reference's does on its kernel
  backend (``use_pallas=True``, a pure-Python call: no Pallas runs).
* Cells against ``Engine.run`` / ``Engine.audit``: every cell of a
  ``run`` sweep (hierarchical, flat, robust, the legacy client scan,
  ``hfl-async`` over ``alpha`` x ``buffer_k``) and of an ``audit`` sweep
  with per-cell methods equals its own call, and a class calls each
  kernel's plain version as often as one cell does.  Folding leaves each
  trial's arithmetic as it was, but a plain product or sum over a larger
  trial axis may reassociate on the CPU, so the counters are held exactly
  and every other metric to rtol 1e-5 (atol 1e-6).
* One sweep under a two-rank trial mesh (gloo ranks of
  ``tests/torch_mesh_ranks.py``) equals the unsharded sweep.
"""
import jax
import numpy as np
import pytest
import torch
from test_torch_hfl import T, assert_metric_matches, data, jax_inputs  # noqa: F401
from torch_mesh_ranks import run_ranks
from torch_parity import one_intra_op_thread  # noqa: F401

from repro import engine as jeng
from repro.core import channel as jch
from repro.core import compression as jcomp
from repro.core import drift as jdrf
from repro.core import energy as jen
from repro.core import faults as jflt
from repro.core import hfl as jhfl
from repro.launch import experiment as jexp
from repro.models import autoencoder as jae
from repro_torch import engine as teng
from repro_torch.core import channel as tch
from repro_torch.core import compression as tcomp
from repro_torch.core import cooperation as tcoop
from repro_torch.core import drift as tdrf
from repro_torch.core import energy as ten
from repro_torch.core import faults as tflt
from repro_torch.core import hfl as thfl
from repro_torch.core.async_fl import AsyncFLConfig
from repro_torch.kernels import ref as tref
from repro_torch.launch import experiment as texp
from repro_torch.models import autoencoder as tae
from repro_torch.optim.sgd import LocalTrainConfig

N, M, E = 12, 3, 1
SEEDS, P = (0, 1), 2
TOL = dict(rtol=1e-5, atol=1e-5)
COUNTERS = ("coop_links", "nonfinite_total", "erased_total", "nonfinite_rounds", "merges")


def assert_cell(got, want, what):
    """A sweep cell's metric against its own call: counters exactly, the
    rest to rtol 1e-5."""
    name = what.split()[-1]
    if name in COUNTERS + ("participation",):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=what)


def _cpu_engine(**kw):
    return teng.Engine(device="cpu", **kw)


# --- per-trial knobs against the reference's hfl.train -----------------------

# Three cells of one class: every knob differs between them.
KNOB_CELLS = (
    dict(wind=3.0, ship=0.2, eta=0.25, rate=1e8, crash=0.1, erase=0.1,
         byz=0.1, current=0.5, every=1.0, shift=0.0),
    dict(wind=8.0, ship=0.7, eta=0.4, rate=5e7, crash=0.2, erase=0.25,
         byz=0.25, current=2.0, every=2.0, shift=0.05),
    dict(wind=5.0, ship=0.5, eta=0.3, rate=2e8, crash=0.0, erase=0.3,
         byz=0.0, current=1.0, every=2.0, shift=0.02),
)


def _knob_cfgs(k):
    """(reference config, port config) of one knob cell: hfl-selective's
    round with sign-flip attackers and drift."""
    common = dict(n_sensors=N, n_fog=M, rounds=T, local_epochs=E,
                  compute_rate_flops=k["rate"])
    cfg_j = jexp.make_config(
        compressor=jcomp.CompressorConfig(rho_s=0.05, quant_bits=8, mode="blockwise"),
        channel=jch.ChannelParams(wind_m_s=k["wind"], shipping=k["ship"]),
        energy=jen.EnergyParams(eta_ea=k["eta"]),
        faults=jflt.FaultConfig(crash_prob=k["crash"], erasure_prob=k["erase"],
                                byz_frac=k["byz"], byz_scale=2.0, byz_mode="sign_flip"),
        drift=jdrf.DriftConfig(sensor_current_m_s=k["current"], reassoc_every=k["every"],
                               covariate_shift=k["shift"]),
        **common)
    cfg_t = texp.make_config(
        common.pop("n_sensors"), common.pop("n_fog"), common.pop("rounds"),
        channel=tch.ChannelParams(wind_m_s=k["wind"], shipping=k["ship"]),
        energy=ten.EnergyParams(eta_ea=k["eta"]),
        faults=tflt.FaultConfig(crash_prob=k["crash"], erasure_prob=k["erase"],
                                byz_frac=k["byz"], byz_scale=2.0, byz_mode="sign_flip"),
        drift=tdrf.DriftConfig(sensor_current_m_s=k["current"], reassoc_every=k["every"],
                               covariate_shift=k["shift"]),
        **common)
    return cfg_j, cfg_t


@pytest.fixture(scope="module")
def folded_vs_reference(data):
    """Each cell's ``hfl.train`` in the reference on its own key, and the
    port's one folded ``hfl.train_trials`` of the three cells on the
    reference's draws."""
    ds, ds_t = data
    want, inputs, cells = [], [], []
    for c, k in enumerate(KNOB_CELLS):
        cfg_j, cfg_t = _knob_cfgs(k)
        key = jax.random.key(20 + c)
        params_j, inp = jax_inputs(key, ds, cfg_j)
        _, k_train = jax.random.split(key)
        want.append(jhfl.train(k_train, params_j, jae.loss, ds, cfg_j))
        inputs.append(inp)
        cells.append(cfg_t)
    folded, swept = teng._fold(cells, 1)
    assert sorted(swept) == sorted(
        ["compute_rate_flops", "channel.wind_m_s", "channel.shipping",
         "energy.eta_ea", "faults.crash_prob", "faults.erasure_prob", "faults.byz_frac",
         "drift.sensor_current_m_s", "drift.reassoc_every", "drift.covariate_shift"])
    got = thfl.train_trials([i.params for i in inputs], tae.loss,
                            thfl.stack_datasets([ds_t] * len(cells)), folded,
                            [i.dep for i in inputs], [i.draws for i in inputs])
    return want, got


@pytest.mark.parametrize("c", range(len(KNOB_CELLS)))
def test_folded_trial_params_equal_the_reference(folded_vs_reference, c):
    want, (params, _) = folded_vs_reference
    np.testing.assert_allclose(tae.ravel(params)[c].numpy(),
                               np.asarray(jax.flatten_util.ravel_pytree(want[c][0])[0]), **TOL)


@pytest.mark.parametrize("field", thfl.RoundMetrics._fields)
def test_folded_trial_metrics_equal_the_reference(folded_vs_reference, field):
    want, (_, m) = folded_vs_reference
    for c in range(len(KNOB_CELLS)):
        assert_metric_matches(field, getattr(m, field)[:, c].numpy(),
                              np.asarray(getattr(want[c][1], field)))


# hfl-adam cells of one class: (server_lr, compute_rate_flops).
ADAM_CELLS = ((0.01, 1e8), (0.03, 3e7), (0.003, 2e8))


@pytest.fixture(scope="module")
def folded_adam_vs_reference(data):
    """Each ``hfl-adam`` cell's ``hfl.train`` in the reference on its own
    key, and the port's one folded ``hfl.train_trials`` of the cells on
    the reference's draws."""
    ds, ds_t = data
    want, inputs, cells = [], [], []
    for c, (lr, rate) in enumerate(ADAM_CELLS):
        cfg_j = jexp.make_config(
            n_sensors=N, n_fog=M, rounds=T, local_epochs=E, server_opt="adam", server_lr=lr,
            compute_rate_flops=rate,
            compressor=jcomp.CompressorConfig(rho_s=0.05, quant_bits=8, mode="blockwise"))
        cfg_t = texp.make_config(N, M, T, local_epochs=E, server_opt="adam", server_lr=lr,
                                 compute_rate_flops=rate)
        key = jax.random.key(30 + c)
        params_j, inp = jax_inputs(key, ds, cfg_j)
        _, k_train = jax.random.split(key)
        want.append(jhfl.train(k_train, params_j, jae.loss, ds, cfg_j))
        inputs.append(inp)
        cells.append(cfg_t)
    folded, swept = teng._fold(cells, 1)
    assert sorted(swept) == ["compute_rate_flops", "server_lr"]
    got = thfl.train_trials([i.params for i in inputs], tae.loss,
                            thfl.stack_datasets([ds_t] * len(cells)), folded,
                            [i.dep for i in inputs], [i.draws for i in inputs])
    return want, got


@pytest.mark.parametrize("c", range(len(ADAM_CELLS)))
def test_folded_adam_trial_params_equal_the_reference(folded_adam_vs_reference, c):
    want, (params, _) = folded_adam_vs_reference
    np.testing.assert_allclose(tae.ravel(params)[c].numpy(),
                               np.asarray(jax.flatten_util.ravel_pytree(want[c][0])[0]), **TOL)


@pytest.mark.parametrize("field", thfl.RoundMetrics._fields)
def test_folded_adam_trial_metrics_equal_the_reference(folded_adam_vs_reference, field):
    want, (_, m) = folded_adam_vs_reference
    for c in range(len(ADAM_CELLS)):
        assert_metric_matches(field, getattr(m, field)[:, c].numpy(),
                              np.asarray(getattr(want[c][1], field)))


def test_per_trial_server_lr_equals_the_reference_adam_step():
    from repro.optim import server as jsrv
    from repro_torch.optim import server as tsrv

    rng = np.random.default_rng(3)
    lrs = np.array([0.01, 0.03, 0.1], np.float32)
    g = [rng.standard_normal((3, 40)).astype(np.float32) for _ in range(2)]
    state = tsrv.init_state((3, 40))
    states_j = [jsrv.init_state(40) for _ in lrs]
    for step in g:
        incr, state = tsrv.adam_update(torch.from_numpy(step), state, lr=torch.from_numpy(lrs))
        for b, lr in enumerate(lrs):
            want, states_j[b] = jsrv.adam_update(jax.numpy.asarray(step[b]), states_j[b],
                                                 lr=float(lr))
            np.testing.assert_allclose(incr[b].numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)


def test_folded_knobs_stay_on_the_host_and_pin_the_layers():
    cells = [_knob_cfgs(k)[1] for k in KNOB_CELLS]
    folded, _ = teng._fold(cells, 2)
    assert folded.channel.wind_m_s.shape == (6,) and folded.channel.wind_m_s.device.type == "cpu"
    np.testing.assert_array_equal(folded.channel.wind_m_s.numpy(), [3, 3, 8, 8, 5, 5])
    assert folded.faults.active is True and folded.drift.active is True
    assert folded.channel.freq_khz == cells[0].channel.freq_khz     # shared: still a float
    sched = thfl.reassoc_schedule(folded.drift, 4, torch.device("cpu"))
    np.testing.assert_array_equal(sched.numpy(), [[1, 1, 1, 1, 1, 1], [1, 1, 0, 0, 0, 0],
                                                  [1, 1, 1, 1, 1, 1], [1, 1, 0, 0, 0, 0]])


# --- classes against the reference's kernel backend ---------------------------

def _kernel_backend(engine, cfg):
    """The reference's ``resolve_config`` as on its kernel backend."""
    cfg = engine.resolve_config(cfg)
    cc, ls = cfg.compressor, cfg.local_solver
    if cc.mode == "blockwise":
        cc = cc.replace(use_pallas=True, interpret=False)
    if ls.fused:
        ls = ls.replace(use_pallas=True, interpret=False)
    return cfg.replace(compressor=cc, local_solver=ls)


def _grid(name):
    """(engine compressor mode, family, [(reference cfg, port cfg)]) of the
    grids of ``tests/test_sweep.py`` and two more of this slice."""
    def both(rounds=2, j_cc=None, t_cc=None, **kw):
        j_kw, t_kw = dict(kw), dict(kw)
        if j_cc is not None:
            j_kw["compressor"], t_kw["compressor"] = j_cc, t_cc
        return (jexp.make_config(n_sensors=N, n_fog=M, rounds=rounds, local_epochs=1, **j_kw),
                texp.make_config(N, M, rounds, local_epochs=1, **t_kw))

    def cc(rho, bits, mode="global"):
        return (jcomp.CompressorConfig(rho_s=rho, quant_bits=bits, mode=mode),
                tcomp.CompressorConfig(rho_s=rho, quant_bits=bits, mode=mode))

    if name == "rho x lr":
        return "auto", "run", [both(lr=lr, j_cc=cc(rho, 8)[0], t_cc=cc(rho, 8)[1])
                               for rho in (0.01, 0.05, 0.1, 0.2) for lr in (0.005, 0.01)]
    if name == "mixed statics":
        base = both(j_cc=cc(0.05, 8)[0], t_cc=cc(0.05, 8)[1])
        return "keep", "run", [
            base,
            both(j_cc=cc(0.1, 8)[0], t_cc=cc(0.1, 8)[1]),
            both(j_cc=cc(1.0, 32)[0], t_cc=cc(1.0, 32)[1]),
            both(j_cc=cc(0.05, 8, "blockwise")[0], t_cc=cc(0.05, 8, "blockwise")[1]),
            (base[0].replace(server_opt="adam"), base[1].replace(server_opt="adam")),
            both(rounds=3, j_cc=cc(0.05, 8)[0], t_cc=cc(0.05, 8)[1]),
        ]
    if name == "audit channel":
        return "auto", "audit", [
            (jexp.make_config(n_sensors=30, n_fog=5, rounds=4,
                              channel=jch.ChannelParams(wind_m_s=w, shipping=s),
                              energy=jen.EnergyParams(eta_ea=eta), compressor=c[0]),
             texp.make_config(30, 5, 4, channel=tch.ChannelParams(wind_m_s=w, shipping=s),
                              energy=ten.EnergyParams(eta_ea=eta), compressor=c[1]))
            for (w, s, eta) in ((3.0, 0.2, 0.25), (8.0, 0.7, 0.4))
            for c in (cc(0.05, 8), cc(1.0, 32))]
    # Layers on and off, robust reduces, the legacy client scan.
    from repro.optim.sgd import LocalTrainConfig as JLocalTrainConfig

    cells = [dict(channel=(jch.ChannelParams(wind_m_s=w), tch.ChannelParams(wind_m_s=w)))
             for w in (3.0, 8.0)]
    cells += [dict(faults=(jflt.FaultConfig(crash_prob=c), tflt.FaultConfig(crash_prob=c)))
              for c in (0.0, 0.2)]
    cells += [dict(drift=(jdrf.DriftConfig(reassoc_every=k), tdrf.DriftConfig(reassoc_every=k)))
              for k in (1.0, 2.0, 3.0)]
    cells += [dict(robust=("trimmed",) * 2, trim_frac=(t,) * 2) for t in (0.1, 0.1, 0.3)]
    cells += [dict(lr=(lr,) * 2, local_solver=(JLocalTrainConfig(fused=False),
                                               LocalTrainConfig(fused=False)))
              for lr in (0.01, 0.02)]
    grid = [(jexp.make_config(n_sensors=N, n_fog=M, rounds=2, local_epochs=1,
                              **{k: v[0] for k, v in c.items()}),
             texp.make_config(N, M, 2, local_epochs=1, **{k: v[1] for k, v in c.items()}))
            for c in cells]
    return "auto", "run", grid


@pytest.mark.parametrize("name", ["rho x lr", "mixed statics", "audit channel", "layers"])
def test_classes_equal_the_reference_kernel_backend(name):
    mode, family, grid = _grid(name)
    j_eng, t_eng = jeng.Engine(compressor=mode), _cpu_engine(compressor=mode)
    j_cfgs = [_kernel_backend(j_eng, cj) for cj, _ in grid]
    t_cfgs = [t_eng.resolve_config(ct) for _, ct in grid]
    _, j_groups = j_eng._sweep_classes(j_cfgs, family, None)
    _, t_groups = t_eng._sweep_classes(t_cfgs, family, None)
    assert list(t_groups.values()) == list(j_groups.values())
    if name == "rho x lr":
        assert len(t_groups) == 8      # rho_s and lr are kernel scalars: no two cells share
    if name == "mixed statics":
        assert [0, 1] in list(t_groups.values()) and len(t_groups) == 5


# --- cells against Engine.run, plain-version calls per class -------------------

_ROUTES = ("local_train_ref", "compress_aggregate_ref", "robust_aggregate_ref")


@pytest.fixture
def route_calls(monkeypatch):
    """Calls of each kernel's plain version (the CPU route of every kernel
    wrapper), by name."""
    calls = dict.fromkeys(_ROUTES, 0)
    for attr in _ROUTES:
        fn = getattr(tref, attr)

        def counted(*a, _fn=fn, _name=attr, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tref, attr, counted)
    return calls


def _base(**kw):
    return texp.make_config(N, M, T, local_epochs=E, **kw)


RUN_GRIDS = {
    "hfl physics": ("hfl-selective", [
        _base(channel=tch.ChannelParams(wind_m_s=w, shipping=s), energy=ten.EnergyParams(eta_ea=e))
        for w in (3.0, 8.0) for s in (0.2, 0.7) for e in (0.25, 0.4)]),
    "hfl-adam server": ("hfl-adam", [_base(server_lr=lr, compute_rate_flops=r)
                                     for lr in (0.01, 0.03) for r in (1e8, 3e7)]),
    "flat drift": ("fedavg", [
        _base(channel=tch.ChannelParams(wind_m_s=w),
              drift=tdrf.DriftConfig(sensor_current_m_s=1.0, reassoc_every=k))
        for w in (3.0, 8.0) for k in (1.0, 2.0)]),
    "robust attack": ("hfl-selective", [
        _base(robust="trimmed", trim_frac=0.3,
              faults=tflt.FaultConfig(byz_frac=b, erasure_prob=p, byz_scale=20.0,
                                      byz_mode="gauss"))
        for b in (0.0, 0.25) for p in (0.0, 0.3)]),
    "legacy scan lr": ("hfl-nearest", [_base(lr=lr, local_solver=LocalTrainConfig(fused=False))
                                       for lr in (0.01, 0.02)]),
    "hfl-async": ("hfl-async", [AsyncFLConfig(base=_base(), n_events=4, alpha=a, buffer_k=k)
                                for a in (0.0, 0.5) for k in (2.0, 6.0)]),
}


@pytest.mark.parametrize("name", list(RUN_GRIDS))
def test_a_class_is_one_call_equal_to_its_cells(data, route_calls, name):
    _, ds_t = data
    method, cfgs = RUN_GRIDS[name]
    eng = _cpu_engine()
    sw = eng.sweep(method, cfgs, SEEDS, ds_t, n_deployments=P)
    sweep_calls = dict(route_calls)
    (log,) = eng.take_log()
    assert sw.n_classes == 1 and log["n_cells"] == len(cfgs) and log["batched"]
    assert sw.classes[0]["knobs"], "the cells differ only in knobs"
    for i, cfg in enumerate(cfgs):
        for k in route_calls:
            route_calls[k] = 0
        run = eng.run(method, cfg, SEEDS, ds_t, n_deployments=P)
        # A class calls each kernel's plain version as often as one cell.
        assert dict(route_calls) == sweep_calls, (i, route_calls, sweep_calls)
        for k, v in run.metrics.items():
            assert_cell(sw.cell(i)[k].numpy(), v.numpy(), f"cell {i} {k}")
    events = T if method != "hfl-async" else cfgs[0].n_events
    assert sweep_calls["local_train_ref"] in (0, events)


def test_unbatched_methods_run_each_trial_with_its_cells_config(data):
    _, ds_t = data
    cfgs = [_base(channel=tch.ChannelParams(wind_m_s=w)) for w in (3.0, 8.0)]
    eng = _cpu_engine()
    sw = eng.sweep("scaffold", cfgs, (0,), ds_t)
    (log,) = eng.take_log()
    assert sw.n_classes == 1 and not log["batched"]
    for i, cfg in enumerate(cfgs):
        run = eng.run("scaffold", cfg, (0,), ds_t)
        for k, v in run.metrics.items():
            assert_cell(sw.cell(i)[k].numpy(), v.numpy(), f"cell {i} {k}")
    assert float(sw["e_total"][0, 0, 0]) != float(sw["e_total"][1, 0, 0])


def test_global_compressor_ratio_sweeps_per_trial(data):
    """Under ``compressor="keep"`` a global Top-K's ``rho_s`` is a (B,)
    knob (each client row its own k), chunked or not."""
    _, ds_t = data
    eng = _cpu_engine(compressor="keep")
    for chunk in (None, 5):
        cfgs = [_base(compressor=tcomp.CompressorConfig(rho_s=r, mode="global"),
                      client_chunk=chunk) for r in (0.02, 0.05, 0.3)]
        sw = eng.sweep("hfl-selective", cfgs, SEEDS, ds_t)
        assert [c["knobs"] for c in sw.classes] == [["compressor.rho_s"]]
        for i, cfg in enumerate(cfgs):
            run = eng.run("hfl-selective", cfg, SEEDS, ds_t)
            for k, v in run.metrics.items():
                assert_cell(sw.cell(i)[k].numpy(), v.numpy(), f"chunk {chunk} cell {i} {k}")


def test_audit_class_takes_a_method_and_payload_per_cell():
    cfgs = [texp.make_config(30, 5, 4, channel=tch.ChannelParams(wind_m_s=w),
                             compressor=tcomp.CompressorConfig(rho_s=rho))
            for w in (3.0, 8.0) for rho in (0.05, 1.0)]
    methods = ["hfl-selective", "fedavg", "hfl-nocoop", "hfl-nearest"]
    eng = _cpu_engine()
    sw = eng.sweep(methods, cfgs, SEEDS, family="audit", n_deployments=P)
    assert sw.n_classes == 1
    assert sw.classes[0]["knobs"] == ["channel.wind_m_s", "l_u"]
    for i, (method, cfg) in enumerate(zip(methods, cfgs)):
        want = eng.audit(method, cfg, SEEDS, n_deployments=P)
        for k, v in want.items():
            assert_cell(sw.cell(i)[k].numpy(), v.numpy(), f"cell {i} {k}")


def test_async_cells_differ_in_their_staleness_knobs(data):
    _, ds_t = data
    _, cfgs = RUN_GRIDS["hfl-async"]
    sw = _cpu_engine().sweep("hfl-async", cfgs, (0,), ds_t)
    merges = sw["merges"][:, 0, 0].tolist()
    assert merges[0] != merges[1] or merges[2] != merges[3]
    assert sw.classes[0]["knobs"] == ["alpha", "buffer_k"]


def test_per_trial_physics_matches_one_trial_calls():
    """The channel and energy functions of a (B,) knob, trial by trial,
    equal the one-trial functions of that trial's value."""
    winds, etas = torch.tensor([3.0, 8.0]), torch.tensor([0.25, 0.4])
    cp = tch.ChannelParams(wind_m_s=winds, gamma_tgt_db=torch.tensor([10.0, 12.0]))
    ep = ten.EnergyParams(eta_ea=etas)
    dist = torch.rand((2, 5, 4), generator=torch.Generator().manual_seed(0)) * 3000.0
    e = ten.tx_energy_j(torch.tensor([800.0, 1200.0]), dist, cp, ep)
    lat = ten.link_latency_s(1000.0, dist, cp)
    for b in range(2):
        one_c = tch.ChannelParams(wind_m_s=float(winds[b]), gamma_tgt_db=10.0 + 2.0 * b)
        one_e = ten.EnergyParams(eta_ea=float(etas[b]))
        np.testing.assert_allclose(e[b].numpy(), ten.tx_energy_j(
            800.0 + 400.0 * b, dist[b], one_c, one_e).numpy(), rtol=1e-6)
        np.testing.assert_allclose(lat[b].numpy(), ten.link_latency_s(
            1000.0, dist[b], one_c).numpy(), rtol=1e-6)
        np.testing.assert_array_equal(tch.feasible(dist, cp)[b].numpy(),
                                      tch.feasible(dist[b], one_c).numpy())
    assert tch.noise_level_db(cp).shape == (2,)
    assert tch.per_trial(winds, dist).shape == (2, 1, 1) and tch.per_trial(3.0, dist) == 3.0
    mask = tflt.byzantine_mask(8, torch.tensor([0.0, 0.25, 0.5]))
    np.testing.assert_array_equal(mask.sum(-1).numpy(), [0, 2, 4])
    dec = tcoop.decide(tcoop.CoopRule.SELECTIVE, torch.rand((2, 4, 3)) * 2000.0,
                       torch.tensor([[3, 1, 0, 2], [0, 4, 1, 1]]), cp)
    assert dec.cooperates.shape == (2, 4)


# --- a sweep under a two-rank trial mesh -------------------------------------

def test_trial_sharded_sweep_equals_the_unsharded_sweep(data, tmp_path):
    _, ds_t = data
    method, cfgs = RUN_GRIDS["hfl physics"]
    cfgs = cfgs[:3]
    want = _cpu_engine().sweep(method, cfgs, SEEDS, ds_t, n_deployments=P).metrics
    ranks = run_ranks([("sweep", method, cfgs, SEEDS, P, ds_t)], 2, tmp_path, timeout_s=120.0)
    for (got,) in ranks:
        (entry,) = got["log"]
        assert entry["trial_sharded"] and entry["n_cells"] == 3
        for k, v in want.items():
            g, w = got["metrics"][k].numpy(), v.numpy()
            assert g.shape == w.shape, k
            if k in ("losses",):
                np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=k)
            elif k in ("f1", "precision", "recall"):
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
            elif k in ("participation",) + COUNTERS:
                np.testing.assert_array_equal(g, w, err_msg=k)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=k)

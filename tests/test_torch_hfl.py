"""Port parity for the training slice end to end: ``core/hfl`` rounds and
``launch/experiment.trial_metrics``, PyTorch vs JAX, at the quick size
(12 sensors, 3 fogs, 3 rounds, E = 1, blockwise compressor).

The JAX reference runs its oracle path (``use_pallas=False``).  Its
random inputs — init params, deployment, and every round's mobility noise
and minibatch index table — are derived from its key exactly as
``trial_metrics`` / ``hfl.train`` derive them, and handed to the port.
The two packages' data generators differ in value, so one dataset (from
the port's generator) goes to both.  Per-round params and every
``RoundMetrics`` field agree to ``rtol=atol=1e-5`` (the tolerance of
``tests/test_fused_agg.py``'s own round-loop pins); the participating
sensors and the cooperation links exactly.
"""
import dataclasses
import tempfile
import types

import jax
import numpy as np
import pytest
import torch
from torch_parity import one_intra_op_thread, reference_rounds  # noqa: F401

from repro.checkpoint import CheckpointStore as JaxStore
from repro.core import compression as jcomp
from repro.core import hfl as jhfl
from repro.core import topology as jtopo
from repro.data.pipeline import multi_epoch_indices as jax_indices
from repro.data.synthetic import SensorDataset as JaxSensorDataset
from repro.launch import experiment as jexp
from repro.models import autoencoder as jae
from repro_torch.checkpoint import CheckpointStore
from repro_torch.core import compression as tcomp
from repro_torch.core import hfl as thfl
from repro_torch.core import topology as ttopo
from repro_torch.core.drift import DriftConfig
from repro_torch.core.faults import FaultConfig
from repro_torch.data.pipeline import multi_epoch_indices
from repro_torch.data.synthetic import SyntheticConfig, generate, normalize
from repro_torch.launch import experiment as texp
from repro_torch.models import autoencoder as tae
from repro_torch.optim.sgd import LocalTrainConfig

N, M, T, E = 12, 3, 3, 1
HIDDEN = (16, 8, 16)
TOL = dict(rtol=1e-5, atol=1e-5)
HFL_METHODS = ("hfl-nocoop", "hfl-selective", "hfl-nearest", "hfl-adam")


def jax_cfg(rounds=T, **kw):
    cc = jcomp.CompressorConfig(rho_s=0.05, quant_bits=8, mode="blockwise")
    return jexp.make_config(n_sensors=N, n_fog=M, rounds=rounds, local_epochs=E, compressor=cc,
                            **kw)


def torch_cfg(rounds=T, **kw):
    return texp.make_config(n_sensors=N, n_fog=M, rounds=rounds, local_epochs=E, **kw)


def jax_inputs(key, ds, cfg):
    """The random inputs ``repro.launch.experiment.trial_metrics(method,
    key, ...)`` consumes, as the port's ``TrialInputs``.  With the fault
    layer on, each round splits the key six ways (``repro.core.hfl``):
    key, mobility, training, Byzantine noise, crash, erasure; the crash
    and erasure uniforms and the ``gauss`` normals go to the port."""
    k_init, k_train = jax.random.split(key)
    params = jae.init(k_init, ds.train.shape[-1], HIDDEN)
    kd, k = jax.random.split(k_train)
    dep = jtopo.sample_deployment(kd, cfg.deployment)
    n, window = ds.train.shape[:2]
    d = tae.param_count(ds.train.shape[-1], HIDDEN)
    faults = cfg.faults.is_active
    gauss = faults and cfg.faults.byz_mode == "gauss"
    noise, batches, crash, erase, byz = [], [], [], [], []
    for _ in range(cfg.rounds):
        if faults:
            k, k_mob, k_tr, k_byz, k_crash, k_erase = jax.random.split(k, 6)
            crash.append(np.array(jax.random.uniform(k_crash, (n,))))
            erase.append(np.array(jax.random.uniform(k_erase, (n,))))
            if gauss:
                byz.append(np.array(jax.random.normal(k_byz, (n, d), jax.numpy.float32)))
        else:
            k, k_mob, k_tr = jax.random.split(k, 3)
        noise.append(np.array(jax.random.normal(k_mob, (cfg.deployment.n_fog, 3))))
        keys = jax.random.split(k_tr, n)
        batches.append(np.array(jax.vmap(
            lambda kk: jax_indices(kk, window, cfg.batch_size, cfg.local_epochs))(keys)))
    dep_t = ttopo.Deployment(*(torch.from_numpy(np.array(a)) for a in
                               (dep.sensor_pos, dep.fog_pos, dep.fog_vel, dep.gateway_pos)))
    draws = thfl.RoundDraws(*(torch.from_numpy(np.stack(x)) if x else None
                              for x in (noise, batches, crash, erase, byz)))
    return params, texp.TrialInputs(tae.from_numpy(params, "cpu"), dep_t, draws)


@pytest.fixture(scope="module")
def data():
    dcfg = SyntheticConfig(n_sensors=N, train_len=48, val_len=24, test_len=48)
    ds_t = normalize(generate(torch.Generator().manual_seed(0), dcfg, device="cpu"))
    return JaxSensorDataset(*(jax.numpy.asarray(t.numpy()) for t in ds_t)), ds_t


def _rounds_through_stores(train_fn, like):
    """Train with a store publishing every round; (per-round params,
    metrics)."""
    with tempfile.TemporaryDirectory() as tmp:
        store = CheckpointStore(tmp, keep=T + 1)
        params, metrics = train_fn(store)
        per_round = [store.restore(like, step)[0] for step in range(1, T + 1)]
    return params, metrics, per_round


def reference_through_store(ds, k_train, params_j, cfg_j):
    """The reference's ``hfl.train(..., store=)``, each round's params read
    back through the port's store: (metrics, per-round params)."""
    like = tae.from_numpy(params_j, "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        store = JaxStore(tmp, keep=T + 1)
        _, m_j = jhfl.train(k_train, params_j, jae.loss, ds, cfg_j, store=store)
        # The two stores write the same npz keys, so the port reads both.
        rounds_j = [CheckpointStore(tmp).restore(like, s)[0] for s in range(1, T + 1)]
    return m_j, rounds_j


def reference_cached(ds, k_train, params_j, cfg_j):
    """The same rounds through the compile-once step of
    ``tests/torch_parity.py``: (metrics, per-round params)."""
    _, m_j, rounds = reference_rounds(jae.loss, ds, cfg_j).run(k_train, params_j)
    return m_j, [tae.from_numpy(p, "cpu") for p in rounds]


def rounds_both(data, seed, cfg_j, cfg_t, *, cached=True):
    """``hfl.train`` in both packages on the reference's draws, publishing
    every round: (metrics_j, per-round params_j, metrics_t, per-round
    params_t, final params_t).  The reference runs through the compile-once
    step unless ``cached`` is false (its own ``train`` with a store, for a
    caller that patches the reference or reads its store)."""
    ds, ds_t = data
    key = jax.random.key(seed)
    _, k_train = jax.random.split(key)
    params_j, inputs = jax_inputs(key, ds, cfg_j)
    like = tae.from_numpy(params_j, "cpu")
    if cached:
        m_j, rounds_j = reference_cached(ds, k_train, params_j, cfg_j)
    else:
        m_j, rounds_j = reference_through_store(ds, k_train, params_j, cfg_j)
    p_t, m_t, rounds_t = _rounds_through_stores(
        lambda store: thfl.train(inputs.params, tae.loss, ds_t, cfg_t, inputs.dep,
                                 inputs.draws, store=store),
        like,
    )
    return m_j, rounds_j, m_t, rounds_t, p_t


def assert_rounds_match(both):
    """Per-round params and every ``RoundMetrics`` field to ``TOL``; the
    participating sensors, links and counters exactly."""
    m_j, rounds_j, m_t, rounds_t, p_t = both
    for pj, pt in zip(rounds_j, rounds_t):
        np.testing.assert_allclose(tae.ravel(pt).numpy(), tae.ravel(pj).numpy(), **TOL)
    np.testing.assert_array_equal(tae.ravel(p_t).numpy(), tae.ravel(rounds_t[-1]).numpy())
    for field in thfl.RoundMetrics._fields:
        assert_metric_matches(field, getattr(m_t, field).numpy(), np.asarray(getattr(m_j, field)))


def assert_metric_matches(field, got, want):
    assert got.shape == want.shape == (T,), field
    if field == "participation":     # the same sensors; the mean may round apart
        np.testing.assert_array_equal(np.round(got * N), np.round(want * N), err_msg=field)
    if field in ("coop_links", "n_nonfinite", "n_erased", "global_finite"):
        np.testing.assert_array_equal(got, want, err_msg=field)
    else:
        np.testing.assert_allclose(got, want, **TOL, err_msg=field)


@pytest.fixture(scope="module")
def selective_rounds(data):
    """Through the reference's store, which the port's store reads."""
    return rounds_both(data, 2, jax_cfg(), torch_cfg(), cached=False)


def test_round_params_match_jax(selective_rounds):
    _, rounds_j, _, rounds_t, p_t = selective_rounds
    for pj, pt in zip(rounds_j, rounds_t):
        np.testing.assert_allclose(tae.ravel(pt).numpy(), tae.ravel(pj).numpy(), **TOL)
    np.testing.assert_array_equal(tae.ravel(p_t).numpy(), tae.ravel(rounds_t[-1]).numpy())
    assert not np.allclose(tae.ravel(rounds_t[0]).numpy(), tae.ravel(rounds_t[-1]).numpy())


@pytest.mark.parametrize("field", thfl.RoundMetrics._fields)
def test_round_metrics_match_jax(selective_rounds, field):
    m_j, _, m_t, _, _ = selective_rounds
    assert_metric_matches(field, getattr(m_t, field).numpy(), np.asarray(getattr(m_j, field)))


@pytest.fixture(scope="module")
def trials(data):
    ds, ds_t = data
    out = {}
    for i, method in enumerate(HFL_METHODS):
        key = jax.random.key(10 + i)
        cfg = jax_cfg()
        _, inputs = jax_inputs(key, ds, cfg)
        out[method] = (
            jexp.trial_metrics(method, key, ds, cfg),
            texp.trial_metrics(method, None, ds_t, torch_cfg(), inputs=inputs, device="cpu"),
        )
    return out


@pytest.mark.parametrize("method", HFL_METHODS)
def test_trial_metrics_match_jax(trials, method):
    want, got = trials[method]
    assert set(want) == set(got)
    for name in ("coop_links", "nonfinite_total", "erased_total", "nonfinite_rounds"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    for name in ("participation", "e_total", "e_s2f", "e_f2f", "e_f2g", "losses", "sim_time_s",
                 "f1", "precision", "recall"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), **TOL,
                                   err_msg=name)


# The hfl-adam keys: 12, 15, 29, 33, 39, 40 and 49 parted from the reference
# (by up to 2.2e-2) while the port rounded both products of Eq. 15's mix
# before their sum; key 45 sits at 1.08e-5, inside TOL.
ADAM_KEYS = tuple(range(10, 30)) + (33, 39, 40, 45, 49)


@pytest.mark.parametrize("key", ADAM_KEYS)
def test_hfl_adam_rounds_match_jax(data, key):
    """FedAdam at the gateway (``server_opt="adam"``) on the reference's
    draws: per-round params and metrics to ``TOL``.  FedAdam's first steps
    divide a global delta by about its own size, so an ulp the port's mix
    left where the reference's is exact 0 became a step of
    O(``server_lr``); the mix is now the reference's contraction."""
    both = rounds_both(data, key, jax_cfg(server_opt="adam"), torch_cfg(server_opt="adam"))
    assert_rounds_match(both)


PIN_CASES = {"selective": (2, {}), "adam": (10, dict(server_opt="adam"))}


def _bits(x):
    a = np.ascontiguousarray(np.asarray(x))
    return a.dtype, a.shape, a.tobytes()


@pytest.mark.parametrize("name", list(PIN_CASES))
def test_cached_reference_rounds_are_its_train_bitwise(data, name):
    """The compile-once step of ``tests/torch_parity.py`` against the
    reference's own ``hfl.train(..., store=)`` on the same inputs: every
    round's params and every ``RoundMetrics`` field bit for bit."""
    ds, _ = data
    seed, kw = PIN_CASES[name]
    cfg = jax_cfg(**kw)
    key = jax.random.key(seed)
    _, k_train = jax.random.split(key)
    params_j, _ = jax_inputs(key, ds, cfg)
    m_c, rounds_c = reference_cached(ds, k_train, params_j, cfg)
    m_s, rounds_s = reference_through_store(ds, k_train, params_j, cfg)
    assert len(rounds_c) == len(rounds_s) == T
    for pc, ps in zip(rounds_c, rounds_s):
        assert _bits(tae.ravel(pc).numpy()) == _bits(tae.ravel(ps).numpy())
    assert m_c._fields == m_s._fields
    for field in m_c._fields:
        assert _bits(getattr(m_c, field)) == _bits(getattr(m_s, field)), field


def test_cached_reference_compiles_once_a_config(data):
    """Two keys of one config share the cache's compile of the round.
    ``init_state``'s battery is weakly typed and a round's output is not,
    so round 1 and the rounds after it are two programs, as in the
    reference's own loop; the second key compiles neither again."""
    ds, _ = data
    ref = reference_rounds(jae.loss, ds, jax_cfg(server_opt="adam"))
    traces = []
    for seed in (10, 11):
        key = jax.random.key(seed)
        params_j, _ = jax_inputs(key, ds, ref.cfg)
        ref.run(jax.random.split(key)[1], params_j)
        traces.append(ref.traces)
    assert traces == [2, 2]
    assert reference_rounds(jae.loss, ds, jax_cfg(server_opt="adam")) is ref


def test_cooperative_mix_is_one_fma_of_the_partner_product():
    """Eq. 15's mix is fma(w_self, theta_m, w_partner theta_peer) with the
    partner product rounded first, as the reference's jitted round
    contracts it: bitwise an f64 product plus sum rounded once, on the
    CPU.  Rounding both products first (the old mix) differs."""
    from repro_torch.core.aggregation import cooperative_mix
    from repro_torch.core.cooperation import CoopDecision

    g = torch.Generator().manual_seed(0)
    fog = torch.randn((4, M, 500), generator=g)
    partner = torch.randint(0, M, (4, M), generator=g)
    ws = torch.rand((4, M), generator=g)
    wp = (1.0 - ws).to(torch.float32)
    dec = CoopDecision(partner, ws, wp, partner != torch.arange(M), torch.zeros((4, M)))
    got = cooperative_mix(fog, dec)
    peer = torch.take_along_dim(fog, partner[..., None], dim=-2)
    pp = wp[..., None] * peer
    want = (ws[..., None].double() * fog.double() + pp.double()).to(torch.float32)
    assert torch.equal(got, want)
    assert not torch.equal(got, ws[..., None] * fog + pp)


def test_global_mode_compressor_round_matches_jax(data):
    """The exact global Top-K path (``mode="global"``, plain torch.topk)
    for one round."""
    ds, ds_t = data
    key = jax.random.key(5)
    cfg_j = jax_cfg(rounds=1).replace(compressor=jcomp.CompressorConfig(mode="global"))
    cfg_t = torch_cfg(rounds=1).replace(compressor=tcomp.CompressorConfig(mode="global"))
    params_j, inputs = jax_inputs(key, ds, cfg_j)
    _, k_train = jax.random.split(key)
    pj, mj = jhfl.train(k_train, params_j, jae.loss, ds, cfg_j)
    pt, mt = thfl.train(inputs.params, tae.loss, ds_t, cfg_t, inputs.dep, inputs.draws)
    np.testing.assert_allclose(tae.ravel(pt).numpy(),
                               tae.ravel(tae.from_numpy(pj, "cpu")).numpy(), **TOL)
    for field in ("loss", "e_total", "latency_s"):
        np.testing.assert_allclose(getattr(mt, field).numpy(), np.asarray(getattr(mj, field)),
                                   **TOL)


def test_global_topk_keeps_exactly_k():
    v = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 1352)).astype(np.float32))
    recon, new_err = tcomp.compress_update(v, torch.zeros_like(v), tcomp.CompressorConfig(
        mode="global", quant_bits=32))
    np.testing.assert_array_equal((recon != 0).sum(-1).numpy(), 68)
    np.testing.assert_array_equal((recon + new_err).numpy(), v.numpy())


@pytest.mark.parametrize("n,bs,epochs", [(48, 32, 1), (70, 32, 3), (256, 32, 5), (40, 16, 2)])
def test_multi_epoch_indices_are_truncated_permutations(n, bs, epochs):
    idx = multi_epoch_indices(torch.Generator().manual_seed(n), 3, n, bs, epochs)
    nb = n // bs
    assert idx.shape == (3, epochs * nb, bs) and idx.dtype == torch.int32
    per_epoch = idx.reshape(3, epochs, nb * bs).numpy()
    assert (per_epoch >= 0).all() and (per_epoch < n).all()
    for row in per_epoch.reshape(-1, nb * bs):
        assert len(np.unique(row)) == nb * bs              # no row twice in an epoch
    assert not np.array_equal(per_epoch[0, 0], per_epoch[1, 0])   # clients differ


def test_draw_trial_is_reproducible_and_sized(data):
    _, ds_t = data
    cfg = torch_cfg()
    a = texp.draw_trial(torch.Generator().manual_seed(4), ds_t, cfg)
    b = texp.draw_trial(torch.Generator().manual_seed(4), ds_t, cfg)
    assert a.draws.mobility.shape == (T, M, 3)
    assert a.draws.batches.shape == (T, N, E * (48 // 32), 32)
    for x, y in zip((a.dep.sensor_pos, a.draws.batches, tae.ravel(a.params)),
                    (b.dep.sensor_pos, b.draws.batches, tae.ravel(b.params))):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize(
    "change,match",
    [
        (dict(local_solver=LocalTrainConfig(fused=False)), "queue 1 item 5"),
    ],
)
def test_legacy_client_scan_matches_the_fused_operator(data, change, match):
    """``fused=False`` (ported by queue-1 item ``match``) runs the legacy
    client scan, whose round agrees with the fused operator's to the round
    pins' tolerance."""
    _, ds_t = data
    g = torch.Generator().manual_seed(0)
    inputs = texp.draw_trial(g, ds_t, torch_cfg(rounds=1))
    got = texp.trial_metrics("hfl-selective", None, ds_t, torch_cfg(rounds=1, **change),
                             inputs=inputs, device="cpu", return_params=True)
    want = texp.trial_metrics("hfl-selective", None, ds_t, torch_cfg(rounds=1), inputs=inputs,
                              device="cpu", return_params=True)
    np.testing.assert_allclose(tae.ravel(got["params"]).numpy(),
                               tae.ravel(want["params"]).numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["losses"].numpy(), want["losses"].numpy(), **TOL)


def test_async_runs_unknown_method_raises_mesh_refuses_as_reference(data):
    """``hfl-async`` runs on a plain config (which takes the async
    defaults); an unknown method raises ``ValueError``; the client mesh
    (``tests/test_torch_mesh.py`` runs it) refuses what the reference
    refuses, with its ``ValueError``s and in its order (a stand-in mesh, as
    ``tests/test_drift.py`` uses): fault injection or a robust reduce, then
    drift, then a sensor count the mesh size does not divide."""
    _, ds_t = data
    g = torch.Generator().manual_seed(0)
    out = texp.trial_metrics("hfl-async", g, ds_t, torch_cfg(), device="cpu")
    assert out["losses"].shape == (texp.async_config(torch_cfg()).n_events,)
    assert float(out["merges"]) > 0 and bool(torch.isfinite(out["f1"]))
    with pytest.raises(ValueError):
        texp.trial_metrics("nope", g, ds_t, torch_cfg(), device="cpu")
    indivisible = types.SimpleNamespace(size=5)
    drift = DriftConfig(sensor_current_m_s=1.0)
    refused = (
        (dict(faults=FaultConfig(crash_prob=0.2)), object(), "fault injection"),
        (dict(robust="trimmed", trim_frac=0.2), object(), "robust aggregation"),
        (dict(robust="median", drift=drift), object(), "robust aggregation"),
        (dict(drift=drift), indivisible, "drift layer"),
        (dict(), indivisible, r"client axis \(12 sensors\) must divide"),
    )
    for method in ("hfl-selective", "fedavg"):
        for kw, mesh, match in refused:
            with pytest.raises(ValueError, match=match):
                texp.trial_metrics(method, g, ds_t, torch_cfg(**kw), client_mesh=mesh,
                                   device="cpu")


def test_config_leaves_out_unported_fields():
    names = {f.name for f in dataclasses.fields(thfl.HFLConfig)}
    assert names == {f.name for f in dataclasses.fields(jhfl.HFLConfig)}
    assert tcomp.CompressorConfig().mode == "blockwise"
    assert not {"use_pallas", "interpret"} & {f.name for f in
                                               dataclasses.fields(tcomp.CompressorConfig)}


def test_trial_publishes_the_returned_params(data, tmp_path):
    _, ds_t = data
    store = CheckpointStore(str(tmp_path), keep=2)
    out = texp.trial_metrics("hfl-selective", torch.Generator().manual_seed(1), ds_t, torch_cfg(),
                             store=store, return_params=True, device="cpu")
    assert store.latest_step() == T
    loaded, _ = store.latest(out["params"])
    np.testing.assert_array_equal(tae.ravel(loaded).numpy(), tae.ravel(out["params"]).numpy())

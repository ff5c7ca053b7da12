"""Port parity for the flat baselines, PyTorch vs JAX: ``core/flat_fl``
(FedAvg, FedProx, FedAdam, SCAFFOLD, the centralised oracle), the legacy
client scan of ``optim/sgd``, ``optim/scaffold``, the flat methods of
``launch/experiment`` and ``data/partition``.

At ``test_torch_hfl.py``'s quick size (12 sensors, 3 fogs, 3 rounds,
E = 1, blockwise rho_s 0.05 int8), on the reference's own draws
(``jax_inputs``: the flat rounds and SCAFFOLD split the key per round as
the hierarchical round does; the centralised oracle's per-epoch tables
come from its own ``split(kt, T * E)``), with one dataset (the port's)
for both.  Tolerance ``TOL`` = ``rtol=atol=1e-5`` on per-round metrics
and final params (``test_torch_hfl.py``'s round pins); the participating
sensors, ``n_erased`` and ``n_nonfinite`` exactly.  SCAFFOLD's control
variates divide the local movement by K * lr (K = 1 step, lr 0.01), so
its params carry the gradients' summation-order differences times 100
into the next round: its pins use ``SCAFFOLD_TOL`` = ``rtol=atol=1e-4``.
The legacy scan (``torch.func`` vmap of ``grad_and_value``) against the
reference's ``jax.value_and_grad`` scan: ``rtol=1e-5, atol=1e-6``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_drift import _drift_cfgs
from test_torch_hfl import (  # noqa: F401  (data is a fixture)
    HIDDEN, N, T, TOL, assert_metric_matches, data, jax_cfg, jax_inputs, torch_cfg,
)
from torch_parity import one_intra_op_thread  # noqa: F401

from repro.core import aggregation as jagg
from repro.core import compression as jcomp
from repro.core import faults as jflt
from repro.core import flat_fl as jflat
from repro.data import partition as jpart
from repro.data.pipeline import multi_epoch_indices as jax_indices
from repro.launch import experiment as jexp
from repro.models import autoencoder as jae
from repro_torch.core import aggregation as tagg
from repro_torch.core import compression as tcomp
from repro_torch.core import faults as tflt
from repro_torch.core import flat_fl as tflat
from repro_torch.data import partition as tpart
from repro_torch.data.synthetic import SyntheticConfig, generate, normalize
from repro_torch.launch import experiment as texp
from repro_torch.models import autoencoder as tae
from repro_torch.optim import scaffold as tscf
from repro_torch.optim import sgd as tsgd
from repro_torch.optim.sgd import LocalTrainConfig

# ``repro.optim`` re-exports a function named ``sgd`` that shadows its module.
jsgd = importlib.import_module("repro.optim.sgd")
jscf = importlib.import_module("repro.optim.scaffold")
SCAFFOLD_TOL = dict(rtol=1e-4, atol=1e-4)
SCAN_TOL = dict(rtol=1e-5, atol=1e-6)
FLAT_CFGS = {
    "fedavg": dict(),
    "fedprox": dict(prox_mu=jexp.PROX_MU),
    "fedadam": dict(server_opt="adam"),
}
FAULTS = dict(byz_mode="adaptive", byz_frac=0.25, byz_scale=2.0, crash_prob=0.2,
              erasure_prob=0.3)


def _ravel(params):
    return tae.ravel(tae.from_numpy(params, "cpu") if not isinstance(params[0]["w"],
                                                                    torch.Tensor) else params)


def flat_both(data, seed, cfg_j, cfg_t, train_j=jflat.train_flat, train_t=tflat.train_flat):
    """One flat training in both packages on the reference's draws:
    (params_j, metrics_j, params_t, metrics_t)."""
    ds, ds_t = data
    key = jax.random.key(seed)
    _, k_train = jax.random.split(key)
    params0, inputs = jax_inputs(key, ds, cfg_j)
    p_j, m_j = train_j(k_train, params0, jae.loss, ds, cfg_j)
    p_t, m_t = train_t(inputs.params, tae.loss, ds_t, cfg_t, inputs.dep, inputs.draws)
    return p_j, m_j, p_t, m_t


def assert_flat_match(both, tol=TOL):
    p_j, m_j, p_t, m_t = both
    np.testing.assert_allclose(_ravel(p_t).numpy(), _ravel(p_j).numpy(), **tol)
    for field in m_t._fields:
        got, want = getattr(m_t, field).numpy(), np.asarray(getattr(m_j, field))
        if tol is TOL or field in ("participation", "coop_links", "n_nonfinite", "n_erased",
                                   "global_finite"):
            assert_metric_matches(field, got, want)
        else:
            np.testing.assert_allclose(got, want, **tol, err_msg=field)


@pytest.mark.parametrize("method", list(FLAT_CFGS))
def test_flat_rounds_match_jax(data, method):
    kw = FLAT_CFGS[method]
    both = flat_both(data, 40, jax_cfg(**kw), torch_cfg(**kw))
    assert_flat_match(both)
    m_t = both[3]
    assert not m_t.coop_links.any() and not m_t.e_f2f.any() and not m_t.e_f2g.any()
    assert 0 < float(m_t.participation[0]) < 1            # direct links only


def _fault_cfgs(**kw):
    return (jax_cfg(faults=jflt.FaultConfig(**FAULTS), **kw),
            torch_cfg(faults=tflt.FaultConfig(**FAULTS), **kw))


@pytest.mark.parametrize("cell", ["faults-trimmed", "reassoc", "chunk", "faults-chunk-median"])
def test_flat_round_cells_match_jax(data, cell):
    """Adaptive colluders (crash 0.2, erasure 0.3) under the trimmed mean;
    re-associating drift in the drift benchmark's world; the sparse wire
    chunk by chunk (``client_chunk=5``); and colluders with the median
    over chunks of the per-client compressor."""
    if cell == "faults-trimmed":
        cfgs = _fault_cfgs(robust="trimmed", trim_frac=0.3)
    elif cell == "reassoc":
        cfgs = _drift_cfgs("reassoc")
    elif cell == "chunk":
        cfgs = (jax_cfg(client_chunk=5), torch_cfg(client_chunk=5))
    else:
        cfg_j, cfg_t = _fault_cfgs(robust="median", client_chunk=5, prox_mu=jexp.PROX_MU)
        cfgs = (cfg_j.replace(compressor=cfg_j.compressor.replace(fused=False)),
                cfg_t.replace(compressor=tcomp.CompressorConfig(fused=False)))
    both = flat_both(data, 41, *cfgs)
    assert_flat_match(both)
    if cell.startswith("faults"):
        assert both[3].n_erased.sum() > 0


@pytest.mark.parametrize("cell", ["plain", "fault-path"])
def test_scaffold_rounds_match_jax(data, cell):
    """SCAFFOLD plain (the weighted mean of raw deltas) and on its fault
    path (Gaussian colluders at scale 5, crash and erasure, the trimmed
    mean through ``ops.robust_aggregate`` with one fog)."""
    if cell == "plain":
        cfgs = (jax_cfg(), torch_cfg())
    else:
        f = dict(byz_mode="gauss", byz_frac=0.25, byz_scale=5.0, crash_prob=0.2,
                 erasure_prob=0.3)
        cfgs = (jax_cfg(faults=jflt.FaultConfig(**f), robust="trimmed", trim_frac=0.3),
                torch_cfg(faults=tflt.FaultConfig(**f), robust="trimmed", trim_frac=0.3))
    both = flat_both(data, 42, *cfgs, train_j=jflat.train_scaffold,
                     train_t=tflat.train_scaffold)
    assert_flat_match(both, SCAFFOLD_TOL)
    assert not both[3].latency_s.any()


def jax_pooled(key, ds, cfg):
    """The centralised oracle's per-epoch tables from the reference's key
    (``flat_fl.train_centralised``: ``kd, kt = split(k_train)``, then
    ``split(kt, T * E)``, one epoch of the pooled rows each)."""
    _, k_train = jax.random.split(key)
    _, kt = jax.random.split(k_train)
    n, window = ds.train.shape[:2]
    keys = jax.random.split(kt, cfg.rounds * cfg.local_epochs)
    return torch.from_numpy(np.stack([
        np.array(jax_indices(k, n * window, cfg.batch_size, 1)) for k in keys]))


def test_centralised_matches_jax(data):
    ds, ds_t = data
    key = jax.random.key(43)
    _, k_train = jax.random.split(key)
    cfg_j, cfg_t = jax_cfg(), torch_cfg()
    params0, inputs = jax_inputs(key, ds, cfg_j)
    pooled = jax_pooled(key, ds, cfg_j)
    assert pooled.shape == (T, N * 48 // 32, 32)
    p_j, l_j, e_j = jflat.train_centralised(k_train, params0, jae.loss, ds, cfg_j)
    p_t, l_t, e_t = tflat.train_centralised(inputs.params, tae.loss, ds_t, cfg_t, inputs.dep,
                                            pooled)
    np.testing.assert_allclose(_ravel(p_t).numpy(), _ravel(p_j).numpy(), **TOL)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), **TOL)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-5)
    assert float(e_t) > 0


@pytest.fixture(scope="module")
def flat_trials(data):
    ds, ds_t = data
    out = {}
    for i, method in enumerate(("fedavg", "fedprox", "fedadam", "scaffold", "centralised")):
        key = jax.random.key(50 + i)
        cfg = jax_cfg()
        _, inputs = jax_inputs(key, ds, cfg)
        if method == "centralised":
            inputs = texp.TrialInputs(inputs.params, inputs.dep, None, jax_pooled(key, ds, cfg))
        out[method] = (jexp.trial_metrics(method, key, ds, cfg),
                       texp.trial_metrics(method, None, ds_t, torch_cfg(), inputs=inputs,
                                          device="cpu"))
    return out


@pytest.mark.parametrize("method", ["fedavg", "fedprox", "fedadam", "scaffold", "centralised"])
def test_flat_trial_metrics_match_jax(flat_trials, method):
    want, got = flat_trials[method]
    assert set(want) == set(got)
    tol = SCAFFOLD_TOL if method == "scaffold" else TOL
    for name in ("coop_links", "nonfinite_total", "erased_total", "nonfinite_rounds"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    for name in ("participation", "e_total", "e_s2f", "e_f2f", "e_f2g", "losses", "sim_time_s",
                 "f1", "precision", "recall"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), **tol,
                                   err_msg=name)


def test_flat_participation_is_below_hierarchical(flat_trials):
    """The paper's gap: direct links reach fewer sensors than fogs do."""
    ds_t = flat_trials["fedavg"][1]
    assert float(ds_t["participation"]) < 1.0
    assert float(flat_trials["centralised"][1]["participation"]) == 1.0


def test_draw_trial_for_the_centralised_oracle(data):
    _, ds_t = data
    cfg = torch_cfg()
    a = texp.draw_trial(torch.Generator().manual_seed(4), ds_t, cfg, method="centralised")
    b = texp.draw_trial(torch.Generator().manual_seed(4), ds_t, cfg)
    assert a.draws is None and b.pooled is None
    assert a.pooled.shape == (T * cfg.local_epochs, N * 48 // 32, 32)
    np.testing.assert_array_equal(tae.ravel(a.params).numpy(), tae.ravel(b.params).numpy())
    np.testing.assert_array_equal(a.dep.sensor_pos.numpy(), b.dep.sensor_pos.numpy())
    rows = a.pooled.reshape(T, -1).numpy()
    assert all(len(np.unique(r)) == r.size for r in rows) and rows.max() < N * 48
    with pytest.raises(ValueError, match="pooled"):
        texp.trial_metrics("centralised", None, ds_t, cfg, inputs=b, device="cpu")


@pytest.mark.parametrize("method", ["fedavg", "scaffold", "centralised"])
def test_run_method_runs_the_flat_methods(data, method):
    _, ds_t = data
    r = texp.run_method(method, ds_t, torch_cfg(rounds=2), seed=3, device="cpu")
    assert r.method == method and np.isfinite(r.f1) and len(r.losses) == (
        2 if method != "centralised" else 2 * 1)
    assert r.coop_links == 0.0 and r.e_f2f == 0.0


def _scan_case(seed, steps=4, bs=8, d=32):
    rng = np.random.default_rng(seed)
    params = jae.init(jax.random.key(seed), d, HIDDEN)
    batches = rng.standard_normal((steps, bs, d)).astype(np.float32)
    return params, batches


@pytest.mark.parametrize("mu", [0.0, 0.01])
def test_local_sgd_matches_jax(mu):
    params, batches = _scan_case(7)
    if mu:
        p_j, l_j = jsgd.proximal_local_sgd(jae.loss, params, jnp.asarray(batches), 0.05, mu)
        p_t, l_t = tsgd.proximal_local_sgd(tae.loss, tae.from_numpy(params, "cpu"),
                                           torch.from_numpy(batches), 0.05, mu)
    else:
        p_j, l_j = jsgd.local_sgd(jae.loss, params, jnp.asarray(batches), 0.05)
        p_t, l_t = tsgd.local_sgd(tae.loss, tae.from_numpy(params, "cpu"),
                                  torch.from_numpy(batches), 0.05)
    np.testing.assert_allclose(tae.ravel(p_t).numpy(), _ravel(p_j).numpy(), **SCAN_TOL)
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-5)


def test_sgd_and_proximal_grad_match_jax():
    params, _ = _scan_case(8)
    grads = jae.init(jax.random.key(9), 32, HIDDEN)
    anchor = jae.init(jax.random.key(10), 32, HIDDEN)
    t = [tae.from_numpy(x, "cpu") for x in (params, grads, anchor)]
    np.testing.assert_allclose(tae.ravel(tsgd.sgd(t[0], t[1], 0.1)).numpy(),
                               _ravel(jsgd.sgd(params, grads, 0.1)).numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        tae.ravel(tsgd.proximal_grad(t[0], t[2], t[1], 0.3)).numpy(),
        _ravel(jsgd.proximal_grad(params, anchor, grads, 0.3)).numpy(), rtol=1e-6)


@pytest.mark.parametrize("mu", [0.0, 0.01])
def test_client_scan_matches_jax_and_the_fused_operator(data, mu):
    """``LocalTrainConfig(fused=False)``: the reference's vmapped scan and
    the port's vmapped steps on the same index tables; and the port's
    scan against its fused operator (the plain ``local_train_ref``)."""
    ds, ds_t = data
    params, inputs = jax_inputs(jax.random.key(44), ds, jax_cfg())
    keys = jax.random.split(jax.random.key(45), N)
    solver_j = jsgd.make_client_solver(jae.loss, batch_size=32, epochs=2, lr=0.01, prox_mu=mu,
                                       solver=jsgd.LocalTrainConfig(fused=False))
    d_j, l_j = solver_j(params, ds.train, keys)
    idx = torch.from_numpy(np.array(jax.vmap(lambda k: jax_indices(k, 48, 32, 2))(keys)))
    kw = dict(batch_size=32, epochs=2, lr=0.01, prox_mu=mu)
    scan = tsgd.make_client_solver(tae.loss, solver=LocalTrainConfig(fused=False), **kw)
    d_t, l_t = scan(inputs.params, ds_t.train, idx)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), **SCAN_TOL)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), rtol=1e-5)
    d_f, l_f = tsgd.make_client_solver(tae.loss, **kw)(inputs.params, ds_t.train, idx)
    np.testing.assert_allclose(d_t.numpy(), d_f.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(l_t.numpy(), l_f.numpy(), rtol=1e-5)


def test_client_scan_takes_other_models():
    """A model the fused operator cannot express (a dict tree, a loss of
    its own) runs on the scan, its deltas in ``ravel_pytree``'s order."""
    from jax.flatten_util import ravel_pytree
    rng = np.random.default_rng(3)
    tree = {"z": rng.standard_normal((4,)).astype(np.float32),
            "a": [rng.standard_normal((4, 4)).astype(np.float32)]}
    data_np = rng.standard_normal((3, 8, 4)).astype(np.float32)

    def loss_j(p, x):
        return jnp.mean((x @ p["a"][0] + p["z"] - x) ** 2)

    def loss_t(p, x):
        return torch.mean((x @ p["a"][0] + p["z"] - x) ** 2)

    keys = jax.random.split(jax.random.key(1), 3)
    d_j, _ = jsgd.make_client_solver(loss_j, batch_size=4, epochs=1, lr=0.1)(
        {"z": jnp.asarray(tree["z"]), "a": [jnp.asarray(tree["a"][0])]}, jnp.asarray(data_np),
        keys)
    idx = torch.from_numpy(np.array(jax.vmap(lambda k: jax_indices(k, 8, 4, 1))(keys)))
    tree_t = {"z": torch.from_numpy(tree["z"]), "a": [torch.from_numpy(tree["a"][0])]}
    d_t, _ = tsgd.make_client_solver(loss_t, batch_size=4, epochs=1, lr=0.1)(
        tree_t, torch.from_numpy(data_np), idx)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), **SCAN_TOL)
    flat, _ = ravel_pytree(tree)
    np.testing.assert_array_equal(tsgd.ravel_tree(tree_t).numpy(), np.asarray(flat))
    back = tsgd.unravel_tree(tsgd.ravel_tree(tree_t), tree_t)
    assert list(back) == ["z", "a"] and torch.equal(back["a"][0], tree_t["a"][0])


def test_scaffold_local_matches_jax():
    params, batches = _scan_case(11, steps=3)
    rng = np.random.default_rng(12)
    d = 1352
    c, ci = (0.01 * rng.standard_normal(d)).astype(np.float32), (
        0.01 * rng.standard_normal(d)).astype(np.float32)
    from jax.flatten_util import ravel_pytree
    _, unravel = ravel_pytree(params)
    p_j, ci_j, l_j = jscf.scaffold_local(jae.loss, params, jnp.asarray(batches), 0.05,
                                         unravel(jnp.asarray(c)), unravel(jnp.asarray(ci)))
    p_t, ci_t, l_t = tscf.scaffold_local(tae.loss, tae.from_numpy(params, "cpu"),
                                         torch.from_numpy(batches), 0.05, torch.from_numpy(c),
                                         torch.from_numpy(ci))
    np.testing.assert_allclose(tae.ravel(p_t).numpy(), _ravel(p_j).numpy(), **SCAN_TOL)
    np.testing.assert_allclose(ci_t.numpy(), np.asarray(ravel_pytree(ci_j)[0]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-5)
    state = tscf.init_state(tae.from_numpy(params, "cpu"), 5)
    assert state.c_global.shape == (d,) and state.c_local.shape == (5, d)
    assert not state.c_global.any() and not state.c_local.any()


@pytest.mark.parametrize("chunk", [None, 3, 12])
def test_compress_and_aggregate_chunk_matches_jax(chunk):
    rng = np.random.default_rng(13)
    n, d, n_fog = 10, 1352, 3
    deltas = rng.standard_normal((n, d)).astype(np.float32)
    err = (0.1 * rng.standard_normal((n, d))).astype(np.float32)
    fog_id = rng.integers(0, n_fog, n).astype(np.int32)
    weights = (48.0 * (rng.random(n) > 0.3)).astype(np.float32)
    args = (deltas, err, fog_id, weights)
    got = tagg.compress_and_aggregate(*(torch.from_numpy(x) for x in args), n_fog,
                                      tcomp.CompressorConfig(), chunk=chunk)
    want = jagg.compress_and_aggregate(*(jnp.asarray(x) for x in args), n_fog,
                                       jcomp.CompressorConfig(mode="blockwise"), chunk=chunk)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0, atol=1e-5)


def test_seed_sweep_and_mean_std():
    cfg = texp.make_config(8, 2, 1, local_epochs=1)

    def ds_fn(seed):
        return normalize(generate(torch.Generator().manual_seed(seed), SyntheticConfig(
            n_sensors=8, train_len=32, val_len=16, test_len=32), device="cpu"))

    runs = texp.seed_sweep("fedavg", ds_fn, cfg, seeds=(0, 1), device="cpu")
    assert [r.method for r in runs] == ["fedavg", "fedavg"]
    again = texp.run_method("fedavg", ds_fn(1), cfg, seed=1, device="cpu")
    assert runs[1] == again
    vals = [0.5, 0.25, 1.0, 0.125]
    mean, std = texp.mean_std(vals)
    want = jexp.mean_std(vals)
    assert mean == pytest.approx(want[0], rel=1e-7) and std == pytest.approx(want[1], rel=1e-6)


def test_partition_matches_the_reference_contracts():
    g = torch.Generator().manual_seed(1)
    p_noniid = tpart.dirichlet_proportions(g, 100, 5, 0.1)
    p_iid = tpart.dirichlet_proportions(g, 100, 5, 1e4)
    assert p_noniid.shape == (100, 5) and p_noniid.dtype == torch.float32
    np.testing.assert_allclose(p_noniid.sum(1).numpy(), 1.0, rtol=1e-5)
    assert float(p_noniid.max(1).values.mean()) > 0.6
    assert float(p_iid.max(1).values.mean()) < 0.35
    x = np.arange(20.0, dtype=np.float32).reshape(10, 2)
    np.testing.assert_array_equal(tpart.contiguous_split(torch.from_numpy(x), 3).numpy(),
                                  np.asarray(jpart.contiguous_split(jnp.asarray(x), 3)))
    assign = tpart.entities_to_sensors(torch.Generator().manual_seed(2), 4, 10)
    assert assign.shape == (10,) and int(assign.max()) <= 3
    np.testing.assert_array_equal(np.sort(assign.numpy()), np.sort(np.arange(10) % 4))
    data_e = torch.arange(8.0).reshape(4, 2)
    np.testing.assert_array_equal(tpart.replicate_entities(data_e, assign).numpy(),
                                  np.asarray(jpart.replicate_entities(
                                      jnp.asarray(data_e.numpy()), jnp.asarray(assign.numpy()))))

"""The client mesh (``launch/sharding.ClientMesh``) on the CPU, over gloo.

Ranks are spawned processes (``tests/torch_mesh_ranks.py``) that meet in
a ``file://`` rendezvous under the test's temporary directory; each
scenario spawns its ranks once, with a timeout of its own, and a rank
that raises fails its tests.  At the size of the reference's own sharded
test (``tests/test_fused_agg.py::test_shard_map_matches_single_device``:
N = 8 sensors, M = 3 fogs, T = 2 rounds, E = 1):

* W = 4, and W = 2 with ``client_chunk`` 2: ``hfl.train`` and
  ``flat_fl.train_flat`` with the mesh against the port's unsharded run
  on the same inputs (energies, latency and battery to rtol 1e-5, losses
  to rtol 1e-4, params to atol 1e-5: the reference's sharded-vs-unsharded
  tolerances; counters exactly), and against the JAX reference on its
  own draws (``test_torch_hfl.jax_inputs``) at the parity tolerance,
  rtol = atol = 1e-5;
* every rank holds the same bits (params and metrics);
* W = 1: bitwise the unsharded run;
* ``hierarchical_mean`` two-level over 2 x 2 groups and flat over the
  mesh equals the weighted mean, ``ring_mix`` mixes in rank r - 1's
  update, and both are identities at size 1;
* ``Engine(shard_clients=True)`` and ``Engine(shard_trials=True)`` at
  W = 2 equal ``Engine()`` without a process group (losses rtol 1e-4, F1
  atol 1e-6, counters exactly: ``tests/test_fused_agg.py``'s engine
  tolerances), with ``client_sharded`` / ``trial_sharded`` logged.
"""
import jax
import numpy as np
import pytest
import torch
from test_torch_hfl import jax_inputs
from torch_mesh_ranks import rank_update, run_ranks
from torch_parity import one_intra_op_thread  # noqa: F401

from repro.core import compression as jcomp
from repro.core import flat_fl as jflat
from repro.core import hfl as jhfl
from repro.data.synthetic import SensorDataset as JaxSensorDataset
from repro.launch import experiment as jexp
from repro.models import autoencoder as jae
from repro_torch.core import flat_fl as tflat
from repro_torch.core import hfl as thfl
from repro_torch.data.synthetic import SyntheticConfig, generate, normalize
from repro_torch.engine import Engine
from repro_torch.launch import experiment as texp
from repro_torch.launch import sharding
from repro_torch.models import autoencoder as tae

N, M, T, E = 8, 3, 2, 1
SEED = 2
TOL = dict(rtol=1e-5, atol=1e-5)
COUNTERS = ("participation", "coop_links", "n_nonfinite", "n_erased", "global_finite")
ENERGY = ("e_s2f", "e_f2f", "e_f2g", "e_total", "latency_s", "battery_min")
SCENARIOS = {"w4": (4, None), "w2-chunk2": (2, 2), "w1": (1, None)}   # (ranks, client_chunk)
FAMILIES = {"hfl": (thfl.train, jhfl.train), "flat": (tflat.train_flat, jflat.train_flat)}
ENGINE = dict(method="hfl-selective", seeds=(0, 1), n_deployments=2)
TIMEOUT_S = 90.0


@pytest.fixture(scope="module")
def data():
    dcfg = SyntheticConfig(n_sensors=N, train_len=48, val_len=24, test_len=48)
    ds_t = normalize(generate(torch.Generator().manual_seed(0), dcfg, device="cpu"))
    return JaxSensorDataset(*(jax.numpy.asarray(t.numpy()) for t in ds_t)), ds_t


def _cfgs(chunk):
    cc = jcomp.CompressorConfig(rho_s=0.05, quant_bits=8, mode="blockwise")
    return (jexp.make_config(n_sensors=N, n_fog=M, rounds=T, local_epochs=E, compressor=cc,
                             client_chunk=chunk),
            texp.make_config(N, M, T, local_epochs=E, client_chunk=chunk))


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """Per scenario: the reference's draws (as the port's inputs), the JAX
    run and the unsharded port run of each family, and every rank's
    results of its jobs (the two families, then the scenario's own)."""
    ds_j, ds_t = data
    key = jax.random.key(SEED)
    _, k_train = jax.random.split(key)
    out = {}
    for name, (world, chunk) in SCENARIOS.items():
        cfg_j, cfg_t = _cfgs(chunk)
        params_j, inputs = jax_inputs(key, ds_j, cfg_j)
        ref = {}
        for family, (train_t, train_j) in FAMILIES.items():
            p_u, m_u = train_t(inputs.params, tae.loss, ds_t, cfg_t, inputs.dep, inputs.draws)
            ref[family] = dict(port=(tae.ravel(p_u), m_u._asdict()),
                               jax=train_j(k_train, params_j, jae.loss, ds_j, cfg_j))
        jobs = [("train", family, cfg_t, ds_t, inputs) for family in FAMILIES]
        if name == "w2-chunk2":
            jobs += [("engine", mode, ENGINE["method"], _cfgs(None)[1], ENGINE["seeds"],
                      ENGINE["n_deployments"], ds_t) for mode in ("clients", "trials")]
        else:
            jobs += [("hier",), ("ring", 0.3)]
        ranks = run_ranks(jobs, world, tmp_path_factory.mktemp(name), timeout_s=TIMEOUT_S)
        out[name] = dict(ref=ref, ranks=ranks)
    return out


def _sharded(runs, name, family):
    return runs[name]["ranks"][0][list(FAMILIES).index(family)]


def _cases(scenarios):
    return [(s, f) for s in scenarios for f in FAMILIES]


@pytest.mark.parametrize("name,family", _cases(("w4", "w2-chunk2")))
def test_sharded_round_matches_the_unsharded_port(runs, name, family):
    got = _sharded(runs, name, family)
    p_u, m_u = runs[name]["ref"][family]["port"]
    np.testing.assert_allclose(got["params"].numpy(), p_u.numpy(), rtol=0, atol=1e-5)
    for field, want in m_u.items():
        g, w = got["metrics"][field].numpy(), want.numpy()
        if field in COUNTERS:
            np.testing.assert_array_equal(g, w, err_msg=field)
        elif field == "loss":
            np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=field)
        else:
            assert field in ENERGY
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=field)


@pytest.mark.parametrize("name,family", _cases(("w4", "w2-chunk2")))
def test_sharded_round_matches_jax(runs, name, family):
    got = _sharded(runs, name, family)
    p_j, m_j = runs[name]["ref"][family]["jax"]
    np.testing.assert_allclose(got["params"].numpy(), tae.ravel(tae.from_numpy(p_j, "cpu")),
                               **TOL)
    for field in thfl.RoundMetrics._fields:
        g, w = got["metrics"][field].numpy(), np.asarray(getattr(m_j, field))
        assert g.shape == w.shape == (T,), field
        if field == "participation":     # the same sensors; the mean may round apart
            np.testing.assert_array_equal(np.round(g * N), np.round(w * N), err_msg=field)
        elif field in COUNTERS:
            np.testing.assert_array_equal(g, w, err_msg=field)
        else:
            np.testing.assert_allclose(g, w, **TOL, err_msg=field)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_every_rank_holds_the_same_bits(runs, name):
    ranks = runs[name]["ranks"]
    assert len(ranks) == SCENARIOS[name][0]
    for family in FAMILIES:
        i = list(FAMILIES).index(family)
        for other in ranks[1:]:
            assert torch.equal(other[i]["params"], ranks[0][i]["params"]), family
            for field, v in ranks[0][i]["metrics"].items():
                assert torch.equal(other[i]["metrics"][field], v), (family, field)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_one_rank_is_bitwise_the_unsharded_round(runs, family):
    got = _sharded(runs, "w1", family)
    p_u, m_u = runs["w1"]["ref"][family]["port"]
    assert torch.equal(got["params"], p_u)
    for field, want in m_u.items():
        assert torch.equal(got["metrics"][field], want), field


def _weighted_mean(world):
    xs = torch.stack([rank_update(r) for r in range(world)])
    w = torch.arange(1, world + 1, dtype=torch.float32)
    return torch.tensordot(w, xs, dims=1) / w.sum()


def test_hierarchical_mean_is_the_weighted_mean(runs):
    want = _weighted_mean(4)
    for r, res in enumerate(runs["w4"]["ranks"]):
        hier = res[2]
        np.testing.assert_allclose(hier["flat"].numpy(), want.numpy(), rtol=1e-6, err_msg=r)
        np.testing.assert_allclose(hier["two_level"].numpy(), want.numpy(), rtol=1e-6,
                                   err_msg=r)


def test_ring_mix_mixes_in_the_previous_rank(runs):
    for r, res in enumerate(runs["w4"]["ranks"]):
        want = 0.7 * rank_update(r) + 0.3 * rank_update((r - 1) % 4)
        np.testing.assert_allclose(res[3]["mixed"].numpy(), want.numpy(), rtol=1e-6)


def test_collectives_are_identities_at_size_one(runs):
    (res,) = runs["w1"]["ranks"]
    x = rank_update(0)
    np.testing.assert_allclose(res[2]["flat"].numpy(), x.numpy())
    assert "two_level" not in res[2]
    np.testing.assert_allclose(res[3]["mixed"].numpy(), x.numpy())


@pytest.mark.parametrize("mode", ["clients", "trials"])
def test_engine_shards_match_the_unsharded_engine(runs, data, mode):
    _, ds_t = data
    eng = Engine(device="cpu")
    want = eng.run(ENGINE["method"], _cfgs(None)[1], ENGINE["seeds"], ds_t,
                   n_deployments=ENGINE["n_deployments"]).metrics
    (log,) = eng.take_log()
    assert not log["client_sharded"] and not log["trial_sharded"]
    job = {"clients": 2, "trials": 3}[mode]
    for res in runs["w2-chunk2"]["ranks"]:
        got = res[job]
        (entry,) = got["log"]
        assert entry["client_sharded"] is (mode == "clients")
        assert entry["trial_sharded"] is (mode == "trials")
        for k, v in want.items():
            g, w = got["metrics"][k].numpy(), v.numpy()
            assert g.shape == w.shape, k
            if k == "losses":
                np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=k)
            elif k in ("f1", "precision", "recall"):
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
            elif k in ("participation", "coop_links", "nonfinite_total", "erased_total",
                       "nonfinite_rounds"):
                np.testing.assert_array_equal(g, w, err_msg=k)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=k)


def test_client_mesh_needs_a_process_group_and_a_divisible_fleet():
    with pytest.raises(RuntimeError, match="init_process_group"):
        sharding.client_mesh()
    mesh = sharding.ClientMesh(None, 1, 4)
    assert mesh.axis_names == ("data",)
    assert mesh.rows(8) == slice(2, 4)
    with pytest.raises(ValueError, match="must divide"):
        mesh.rows(10)

"""The port's runnable examples on the CPU (``repro_torch.examples``: the
quickstart, the SMD training driver, train-and-serve, the load replay),
and the last small ports held against the JAX package: ``optim/sgd.adam``,
``core/compression.init_error``, ``data/pipeline.epoch_batches`` /
``multi_epoch_batches`` and ``core/flat_fl.ScaffoldTrainState``.

The reference has no test of ``sgd.adam``: the port's params after three
steps are held to within 1e-6 of each leaf's largest magnitude (f32, the
same update order); the batches, on the reference's own permutations and
index tables, exactly.
"""
import importlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import one_intra_op_thread  # noqa: F401

from repro.core import compression as jcomp
from repro.core import flat_fl as jflat
from repro.data import pipeline as jpipe
from repro.models import autoencoder as jae
from repro_torch.core import compression as tcomp
from repro_torch.core import flat_fl as tflat
from repro_torch.data import pipeline as tpipe
from repro_torch.examples import load_replay, quickstart, serve_anomaly, train_iout_hfl
from repro_torch.models import autoencoder as tae
from repro_torch.optim import sgd as tsgd

jsgd = importlib.import_module("repro.optim.sgd")   # the package exports a function ``sgd``
ADAM_TOL = 1e-6     # of each leaf's largest magnitude, f32


# --- the examples ------------------------------------------------------------

def test_quickstart():
    res = quickstart.main(["--device", "cpu"])
    assert tuple(res) == quickstart.METHODS
    for method, r in res.items():
        assert r.method == method and 0.0 <= r.f1 <= 1.0 and 0.0 < r.participation <= 1.0
        assert r.e_total == pytest.approx(r.e_s2f + r.e_f2f + r.e_f2g, rel=1e-5)
    assert res["fedavg"].e_f2f == 0.0 and res["fedavg"].e_f2g == 0.0
    assert res["hfl-nocoop"].e_f2f == 0.0
    assert res["hfl-selective"].e_f2f <= res["hfl-nearest"].e_f2f


def test_train_iout_hfl(tmp_path, capsys):
    out = train_iout_hfl.main(["--rounds", "2", "--local-epochs", "1", "--ckpt-dir",
                               str(tmp_path)], device="cpu")
    text = capsys.readouterr().out
    assert "dataset: SMD (surrogate), 10 entities, D=38" in text and "PA-F1" in text
    assert out["source"] == "surrogate" and out["entities"] == 10 and len(out["rounds"]) == 2
    for row in out["rounds"]:
        assert np.isfinite(row["loss"]) and 0.0 < row["participation"] <= 1.0
        assert row["e_total"] > 0.0 and row["battery_min"] > 0.0
    assert out["checkpoints"] == sorted(os.listdir(tmp_path)) and len(out["checkpoints"]) == 2
    assert 0.0 <= out["f1"] <= 1.0


def test_serve_anomaly_example_end_to_end(tmp_path):
    """The reference's acceptance pin (tests/test_serving.py), on the port's
    CLI: train -> publish -> serve with a mid-stream hot-swap and no
    recompile after warmup."""
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_anomaly", "--rounds", "4",
         "--n-sensors", "8", "--train-len", "48", "--batch-rows", "256", "--ckpt-dir",
         str(tmp_path), "--device", "cpu"],
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    summary = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert summary["swapped"] is True
    assert summary["service"]["swaps"] >= 1
    assert summary["service"]["compiles"] == 1
    assert summary["mean_abs_error_shift"] > 0.0
    assert summary["service"]["samples"] > 0
    assert 0.0 <= summary["f1"] <= 1.0
    assert summary["rounds_published"] == [2, 3, 4] and summary["served_round"] == 4


def test_serve_anomaly_returns_what_it_prints(tmp_path, capsys):
    out = serve_anomaly.main(["--rounds", "2", "--n-sensors", "6", "--train-len", "48",
                              "--batch-rows", "128", "--ckpt-dir", str(tmp_path)], device="cpu")
    text = capsys.readouterr().out
    assert json.loads(text[text.index("{"):]) == json.loads(json.dumps(out))
    assert out["service"]["swaps"] >= 1 and out["served_round"] == 2


def test_load_replay():
    out = load_replay.main(["--duration", "1", "--int8"], device="cpu")
    assert set(out) == {"trace", "fixed", "adaptive_bucketed", "adaptive_bucketed_int8",
                        "p99_speedup"}
    assert out["fixed"]["compiles_by_bucket"] == {1024: 1}
    for key in ("fixed", "adaptive_bucketed", "adaptive_bucketed_int8"):
        s = out[key]
        assert s["completed"] == out["trace"]["n_events"] and s["e2e_p99_ms"] >= s["e2e_p50_ms"]
    assert out["p99_speedup"] == (out["fixed"]["e2e_p99_ms"]
                                  / out["adaptive_bucketed"]["e2e_p99_ms"])


# --- adam, init_error, batches, the SCAFFOLD state ----------------------------

def _ae_tree(rng, d=12, hidden=(6, 3, 6)):
    dims = (d,) + hidden + (d,)
    return [{"w": rng.standard_normal((a, b)).astype(np.float32),
             "b": rng.standard_normal(b).astype(np.float32)} for a, b in zip(dims, dims[1:])]


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_matches_the_reference(weight_decay):
    rng = np.random.default_rng(7)
    p_np = _ae_tree(rng)
    grads_np = [_ae_tree(rng) for _ in range(3)]
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    tp = [{k: torch.from_numpy(v.copy()) for k, v in layer.items()} for layer in p_np]
    jst, tst = jsgd.adam_init(jp), tsgd.adam_init(tp)
    for g in grads_np:
        jp, jst = jsgd.adam(jp, jax.tree_util.tree_map(jnp.asarray, g), jst, 1e-2,
                            weight_decay=weight_decay)
        tp, tst = tsgd.adam(tp, [{k: torch.from_numpy(v.copy()) for k, v in layer.items()}
                                 for layer in g], tst, 1e-2, weight_decay=weight_decay)
    assert int(tst.count) == int(jst.count) == 3 and tst.count.dtype == torch.int32
    for name, t_tree, j_tree in (("params", tp, jp), ("mu", tst.mu, jst.mu),
                                 ("nu", tst.nu, jst.nu)):
        for t_layer, j_layer in zip(t_tree, j_tree):
            for k in ("w", "b"):
                want = np.asarray(j_layer[k])
                got = t_layer[k].numpy()
                assert got.dtype == np.float32
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=ADAM_TOL * np.abs(want).max(), err_msg=name)


def test_init_error_matches_the_reference():
    jp = jae.init(jax.random.key(0), 32, (16, 8, 16))
    want = np.asarray(jcomp.init_error(jp))
    tp = tae.init(torch.Generator().manual_seed(0), 32, (16, 8, 16), device="cpu")
    got = tcomp.init_error(tp)
    assert got.shape == want.shape == (tae.param_count(32, (16, 8, 16)),)
    assert got.dtype == torch.float32 and not got.any()


@pytest.mark.parametrize("n,bs", [(16, 4), (19, 4), (48, 16)])
def test_epoch_batches_match_the_reference(n, bs):
    data = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    key = jax.random.key(n)
    want = np.asarray(jpipe.epoch_batches(key, jnp.asarray(data), bs))
    perm = torch.from_numpy(np.array(jax.random.permutation(key, n)))
    got = tpipe.epoch_batches(None, torch.from_numpy(data), bs, perm=perm)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,bs,epochs", [(16, 4, 3), (19, 4, 2)])
def test_multi_epoch_batches_match_the_reference(n, bs, epochs):
    data = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    key = jax.random.key(n + epochs)
    want = np.asarray(jpipe.multi_epoch_batches(key, jnp.asarray(data), bs, epochs))
    idx = torch.from_numpy(np.array(jpipe.multi_epoch_indices(key, n, bs, epochs)))
    got = tpipe.multi_epoch_batches(None, torch.from_numpy(data), bs, epochs, idx=idx)
    np.testing.assert_array_equal(got.numpy(), want)


def test_batches_from_a_generator_cover_the_data():
    """The invariants of the reference's tests/test_data.py."""
    data = torch.arange(32.0).reshape(16, 2)
    b = tpipe.epoch_batches(torch.Generator().manual_seed(0), data, 4)
    assert b.shape == (4, 4, 2)
    assert torch.equal(torch.sort(b[..., 0].reshape(-1)).values, data[:, 0])
    m = tpipe.multi_epoch_batches(torch.Generator().manual_seed(0), data, 4, 3)
    assert m.shape == (12, 4, 2)
    for e in range(3):
        assert torch.equal(torch.sort(m[4 * e: 4 * e + 4, :, 0].reshape(-1)).values, data[:, 0])


def test_scaffold_train_state_is_the_reference_state():
    assert tflat.ScaffoldTrainState._fields == jflat.ScaffoldTrainState._fields == ("fl", "ctrl")

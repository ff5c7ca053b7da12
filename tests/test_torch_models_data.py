"""Port parity: autoencoder, anomaly metrics and synthetic data.

The autoencoder and the metrics take the same numpy inputs in both
packages and agree to float tolerance.  ``data.synthetic.generate`` draws
from ``torch.Generator`` and cannot be bit-compared with ``jax.random``,
so it is held to its properties; ``normalize`` is compared directly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import one_intra_op_thread  # noqa: F401

from repro.core import anomaly as janom
from repro.data import synthetic as jsyn
from repro.models import autoencoder as jae
from repro_torch.core import anomaly as tanom
from repro_torch.data import synthetic as tsyn
from repro_torch.models import autoencoder as tae


def _pair(d=32, hidden=(16, 8, 16), seed=0):
    pj = jax.tree_util.tree_map(np.asarray, jae.init(jax.random.key(seed), d, hidden))
    return pj, tae.from_numpy(pj, "cpu")


@pytest.mark.parametrize("d,hidden", [(32, (16, 8, 16)), (130, (64, 8, 64))])
def test_apply_and_loss_match_jax(d, hidden):
    pj, pt = _pair(d, hidden)
    x = np.random.default_rng(d).standard_normal((50, d)).astype(np.float32)
    np.testing.assert_allclose(
        tae.apply(pt, torch.from_numpy(x)).numpy(), np.asarray(jae.apply(pj, x)),
        rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(
        float(tae.loss(pt, torch.from_numpy(x))), float(jae.loss(pj, x)), rtol=1e-5
    )


def test_init_is_glorot_and_seeded():
    a = tae.init(torch.Generator().manual_seed(5), device="cpu")
    b = tae.init(torch.Generator().manual_seed(5), device="cpu")
    assert [tuple(layer["w"].shape) for layer in a] == [(32, 16), (16, 8), (8, 16), (16, 32)]
    for la, lb in zip(a, b):
        torch.testing.assert_close(la["w"], lb["w"], rtol=0, atol=0)
        assert not la["b"].any()
    big = tae.init(torch.Generator().manual_seed(0), 400, (400,), device="cpu")
    std = float(big[0]["w"].std())
    assert abs(std - np.sqrt(2.0 / 800)) / np.sqrt(2.0 / 800) < 0.02
    assert tae.param_count() == jae.param_count() == 1352
    assert tae.param_count(130, (64, 8, 64)) == jae.param_count(130, (64, 8, 64))


def test_numpy_round_trip_keeps_dtypes():
    q = [{"qw": np.ones((3, 2), np.int8), "sw": np.ones((1, 2), np.float32),
          "b": np.zeros(2, np.float32)}]
    t = tae.from_numpy(q, "cpu")
    assert t[0]["qw"].dtype == torch.int8
    back = tae.to_numpy(t)
    for k in q[0]:
        assert back[0][k].dtype == q[0][k].dtype
        np.testing.assert_array_equal(back[0][k], q[0][k])


def test_anomaly_metrics_match_jax():
    rng = np.random.default_rng(3)
    pred = rng.uniform(size=400) < 0.3
    label = np.zeros(400, bool)
    for s in (10, 100, 250, 390):
        label[s : s + 7] = True
    for fn_t, fn_j in ((tanom.pointwise_f1, janom.pointwise_f1),
                       (tanom.point_adjusted_f1, janom.point_adjusted_f1)):
        rt, rj = fn_t(torch.from_numpy(pred), torch.from_numpy(label)), fn_j(pred, label)
        for a, b in zip(rt, rj):
            assert float(a) == pytest.approx(float(b), rel=1e-6)
    np.testing.assert_array_equal(
        tanom.point_adjust(torch.from_numpy(pred), torch.from_numpy(label)).numpy(),
        np.asarray(janom.point_adjust(pred, label)),
    )
    errs = rng.uniform(size=333).astype(np.float32)
    np.testing.assert_allclose(
        float(tanom.calibrate_threshold(torch.from_numpy(errs), 99.0)),
        float(janom.calibrate_threshold(jnp.asarray(errs), 99.0)), rtol=1e-6,
    )


def test_evaluate_detector_matches_jax():
    pj, pt = _pair(seed=2)
    rng = np.random.default_rng(4)
    val = rng.standard_normal((200, 32)).astype(np.float32)
    test = rng.standard_normal((300, 32)).astype(np.float32)
    label = np.zeros(300, bool)
    label[50:80] = True
    test[label] += 2.0
    for pa in (False, True):
        rt = tanom.evaluate_detector(
            tae.apply, pt, torch.from_numpy(val), torch.from_numpy(test),
            torch.from_numpy(label), point_adjusted=pa,
        )
        rj = janom.evaluate_detector(jae.apply, pj, val, test, label, point_adjusted=pa)
        assert float(rt.f1) == pytest.approx(float(rj.f1), rel=1e-6)


def test_normalize_matches_jax():
    rng = np.random.default_rng(9)
    n = 6
    ds = [rng.standard_normal((n, ln, 32)).astype(np.float32) * 3 + 1 for ln in (48, 24, 40)]
    lab = rng.uniform(size=(n, 40)) < 0.1
    ns = np.full((n,), 48.0, np.float32)
    jd = jsyn.normalize(jsyn.SensorDataset(*ds, lab, ns))
    td = tsyn.normalize(tsyn.SensorDataset(*(torch.from_numpy(a) for a in ds),
                                           torch.from_numpy(lab), torch.from_numpy(ns)))
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("label_shift", [0.0, 0.5])
def test_generate_shapes_labels_and_determinism(label_shift):
    cfg = tsyn.SyntheticConfig(n_sensors=12, train_len=48, val_len=24, test_len=60,
                               label_shift=label_shift)
    ds = tsyn.generate(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert ds.train.shape == (12, 48, 32) and ds.val.shape == (12, 24, 32)
    assert ds.test.shape == (12, 60, 32) and ds.test_label.shape == (12, 60)
    assert ds.test_label.dtype == torch.bool
    torch.testing.assert_close(ds.n_samples, torch.full((12,), 48.0))
    assert all(bool(torch.isfinite(t).all()) for t in (ds.train, ds.val, ds.test))
    # ~3 segments of int(rate * len / 3) points: the label rate is at most
    # anomaly_rate and at least one segment's worth per sensor.
    seg = int(cfg.anomaly_rate * cfg.test_len / 3)
    per_sensor = ds.test_label.sum(1)
    assert bool((per_sensor >= seg).all()) and bool((per_sensor <= 3 * seg).all())
    if label_shift:
        first = ds.test_label.int().argmax(1)
        assert int(first.min()) >= int(label_shift * (cfg.test_len - seg))
    again = tsyn.generate(torch.Generator().manual_seed(0), cfg, device="cpu")
    other = tsyn.generate(torch.Generator().manual_seed(1), cfg, device="cpu")
    for a, b in zip(ds, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(ds.train, other.train)


def test_generate_anomalies_move_the_data_and_normalize_standardises():
    cfg = tsyn.SyntheticConfig(n_sensors=20, train_len=128, val_len=32, test_len=64)
    ds = tsyn.normalize(tsyn.generate(torch.Generator().manual_seed(2), cfg, device="cpu"))
    torch.testing.assert_close(ds.train.mean(1), torch.zeros(20, 32), rtol=0, atol=1e-4)
    torch.testing.assert_close(
        ds.train.std(1, unbiased=False), torch.ones(20, 32), rtol=0, atol=1e-3
    )
    lab = ds.test_label
    dev_anom = ds.test[lab].abs().mean()
    dev_norm = ds.test[~lab].abs().mean()
    assert float(dev_anom) > 1.5 * float(dev_norm)


def test_generate_covariate_shift_ramps_the_mean():
    base = tsyn.SyntheticConfig(n_sensors=8, train_len=64, val_len=16, test_len=32)
    shifted = tsyn.SyntheticConfig(n_sensors=8, train_len=64, val_len=16, test_len=32,
                                   covariate_shift=4.0)
    a = tsyn.generate(torch.Generator().manual_seed(3), base, device="cpu")
    b = tsyn.generate(torch.Generator().manual_seed(3), shifted, device="cpu")
    torch.testing.assert_close(b.train[:, 0], a.train[:, 0], rtol=0, atol=1e-6)
    assert float((b.val - a.val).mean()) > 1.0

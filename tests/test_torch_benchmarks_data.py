"""Port parity for the benchmark-data loader (``data/benchmarks``),
PyTorch vs JAX.

* ``SPECS`` (SMD 10 x 38, SMAP 55 x 25, MSL 27 x 55) and their published
  anomaly rates equal the reference's.
* On ``.npy`` files written here in the OmniAnomaly layout (more entities
  than the spec takes, series of uneven length, longer than the cut), the
  port's ``load`` equals ``repro.data.benchmarks.load``: source
  ``"real"``, the same shapes, the splits as read, labels and weights
  bitwise; the normalised splits to rtol 1e-5 / atol 1e-6 (the two
  libraries' mean and std reductions round apart by an ulp or two).
* Without files the port gives the surrogate with the spec's shapes, a
  test anomaly rate near the spec's, and the same data again from the
  same seed.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import one_intra_op_thread  # noqa: F401

from repro.data import benchmarks as jbench
from repro_torch.data import benchmarks as tbench

LENGTH = 32


def test_specs_equal_the_reference():
    assert set(tbench.SPECS) == set(jbench.SPECS) == {"smd", "smap", "msl"}
    for name, spec in tbench.SPECS.items():
        assert dataclasses.astuple(spec) == dataclasses.astuple(jbench.SPECS[name])
    assert [f.name for f in dataclasses.fields(tbench.BenchmarkSpec)] == [
        f.name for f in dataclasses.fields(jbench.BenchmarkSpec)]
    assert tbench.BenchmarkData._fields == jbench.BenchmarkData._fields


def _write_real(root, name, n_entities, dim, seed):
    """OmniAnomaly-layout files for ``n_entities`` entities of uneven
    length (some longer than the loader's 4 * LENGTH cut)."""
    rng = np.random.default_rng(seed)
    d = root / name
    d.mkdir()
    for e in range(n_entities):
        n_train, n_test = int(rng.integers(60, 160)), int(rng.integers(50, 150))
        np.save(d / f"machine-{e:02d}_train.npy",
                rng.normal(size=(n_train, dim)).astype(np.float32) * (1 + e))
        np.save(d / f"machine-{e:02d}_test.npy",
                rng.normal(size=(n_test, dim)).astype(np.float32))
        np.save(d / f"machine-{e:02d}_labels.npy", (rng.random(n_test) < 0.1).astype(np.int64))


@pytest.mark.parametrize("name,extra", [("smd", 2), ("msl", -20)])
def test_real_files_load_as_the_reference_does(tmp_path, name, extra):
    """What is read (the splits, labels and weights) equals the reference
    bitwise; the normalised splits agree to the f32 rounding of the two
    libraries' mean and std reductions."""
    spec = tbench.SPECS[name]
    _write_real(tmp_path, name, spec.n_entities + extra, spec.feature_dim, 7)
    raw = tbench._try_load_real(spec, str(tmp_path), 4 * LENGTH, torch.device("cpu"))
    raw_j = jbench._try_load_real(jbench.SPECS[name], str(tmp_path), 4 * LENGTH)
    got = tbench.load(name, data_dir=str(tmp_path), length=LENGTH, device="cpu")
    want = jbench.load(name, data_dir=str(tmp_path), length=LENGTH)
    assert got.source == want.source == "real"
    for field, r, rj, g, w in zip(want.dataset._fields, raw, raw_j, got.dataset, want.dataset):
        w = np.asarray(w)
        assert tuple(r.shape) == tuple(g.shape) == w.shape, field
        assert g.device.type == "cpu" and str(g.dtype).split(".")[-1] == str(w.dtype), field
        np.testing.assert_array_equal(r.numpy(), np.asarray(rj), err_msg=field)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6, err_msg=field)
    np.testing.assert_array_equal(got.dataset.test_label.numpy(),
                                  np.asarray(want.dataset.test_label))
    assert got.dataset.train.shape[0] == min(spec.n_entities, spec.n_entities + extra)


@pytest.mark.parametrize("name", list(tbench.SPECS))
def test_surrogate_without_files(tmp_path, name):
    spec = tbench.SPECS[name]
    got = tbench.load(name.upper(), data_dir=str(tmp_path), seed=3, device="cpu")
    assert got.source == "surrogate"
    ds = got.dataset
    length = 512                     # the loader's default
    assert tuple(ds.train.shape) == (spec.n_entities, length, spec.feature_dim)
    assert tuple(ds.val.shape) == (spec.n_entities, length // 4, spec.feature_dim)
    assert tuple(ds.test.shape) == (spec.n_entities, length, spec.feature_dim)
    assert tuple(ds.test_label.shape) == (spec.n_entities, length)
    assert ds.test_label.dtype == torch.bool
    torch.testing.assert_close(ds.n_samples, torch.full((spec.n_entities,), float(length)))
    # Three segments of int(rate * length / 3) points per entity, which may overlap.
    seg = int(spec.anomaly_rate * length / 3)
    rate = float(ds.test_label.float().mean())
    assert seg / length <= rate <= 3 * seg / length <= spec.anomaly_rate
    assert rate >= 0.8 * spec.anomaly_rate
    # Normalised per entity on the train split.
    torch.testing.assert_close(ds.train.mean(dim=1), torch.zeros(spec.n_entities,
                                                                 spec.feature_dim),
                               atol=1e-5, rtol=0)
    again = tbench.load(name, data_dir=str(tmp_path), seed=3, device="cpu")
    for a, b in zip(ds, again.dataset):
        assert torch.equal(a, b)
    other = tbench.load(name, data_dir=str(tmp_path), seed=4, length=64, device="cpu")
    assert not torch.equal(ds.train[:, :64], other.dataset.train)

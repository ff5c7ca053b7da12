"""Port parity: checkpoints cross-load between ``repro`` and ``repro_torch``.

Both packages write the same flat-npz key paths (``jax.tree_util.keystr``
of each leaf), so either loads the other's rounds bit for bit.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointStore as JaxStore
from repro.checkpoint import load_pytree as jax_load
from repro.checkpoint import save_pytree as jax_save
from repro.models import autoencoder as jae
from repro_torch.checkpoint import CheckpointStore, load_pytree, save_pytree
from repro_torch.checkpoint.store import _flatten
from repro_torch.models import autoencoder as tae


def _jax_params(seed=0, d=32, hidden=(16, 8, 16)):
    return jae.init(jax.random.key(seed), d, hidden)


def test_keys_equal_jax_keystr():
    params = _jax_params()
    jax_keys = {
        jax.tree_util.keystr(path)
        for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]
    }
    tp = tae.from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    assert set(_flatten(tp)) == jax_keys
    assert "[0]['b']" in jax_keys
    nested = {"opt": (np.zeros(2), [np.ones(1)]), "a": np.zeros(3)}
    jax_nested = {
        jax.tree_util.keystr(path)
        for path, _ in jax.tree_util.tree_flatten_with_path(nested)[0]
    }
    assert set(_flatten(nested)) == jax_nested


def test_jax_store_read_by_port_bit_identical(tmp_path):
    params = _jax_params(1)
    JaxStore(str(tmp_path), keep=3).publish(4, params)
    like = tae.init(torch.Generator().manual_seed(0), device="cpu")
    restored, step = CheckpointStore(str(tmp_path)).latest(like)
    assert step == 4
    for lj, lt in zip(params, restored):
        for k in ("w", "b"):
            assert lt[k].dtype == torch.float32
            np.testing.assert_array_equal(lt[k].numpy(), np.asarray(lj[k]))


def test_port_store_read_by_jax_bit_identical(tmp_path):
    params = tae.init(torch.Generator().manual_seed(3), device="cpu")
    CheckpointStore(str(tmp_path), keep=3).publish(7, params)
    restored, step = JaxStore(str(tmp_path)).latest(_jax_params())
    assert step == 7
    for lt, lj in zip(params, restored):
        for k in ("w", "b"):
            np.testing.assert_array_equal(np.asarray(lj[k]), lt[k].numpy())


def test_int8_trees_cross_load(tmp_path):
    """Quantised {"qw", "sw", "b"} trees keep their dtypes both ways."""
    from repro.serving.score import quantize_params as jquant

    qj = jax.tree_util.tree_map(np.asarray, jquant(_jax_params(2)))
    path = str(tmp_path / "q.npz")
    jax_save(path, qj)
    like = tae.from_numpy(qj, "cpu")
    back = load_pytree(path, like)
    for lj, lt in zip(qj, back):
        assert lt["qw"].dtype == torch.int8
        for k in ("qw", "sw", "b"):
            np.testing.assert_array_equal(lt[k].numpy(), lj[k])
    path2 = str(tmp_path / "q2.npz")
    save_pytree(path2, back)
    again = jax_load(path2, qj)
    for lj, la in zip(qj, again):
        for k in ("qw", "sw", "b"):
            np.testing.assert_array_equal(np.asarray(la[k]), lj[k])


def test_load_checks_keys_and_shapes(tmp_path):
    params = tae.init(torch.Generator().manual_seed(0), device="cpu")
    path = str(tmp_path / "p.npz")
    save_pytree(path, params)
    wrong = tae.init(torch.Generator().manual_seed(0), 32, (16, 4, 16), device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        load_pytree(path, wrong)
    with pytest.raises(KeyError, match="missing leaf"):
        load_pytree(path, params + [{"w": torch.zeros(1), "b": torch.zeros(1)}])


def test_store_retention_atomic_save_and_aliases(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    like = tae.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(FileNotFoundError):
        store.restore(like)
    for step in (1, 2, 3):
        store.publish(step, [{k: v * step for k, v in layer.items()} for layer in like])
    assert store.steps() == [2, 3] and store.latest_step() == 3
    restored, step = store.latest(like)
    assert step == 3
    torch.testing.assert_close(restored[0]["w"], like[0]["w"] * 3, rtol=0, atol=0)
    # No temp files are left behind by a completed save.
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".inflight-")]


def test_failed_save_leaves_no_partial_file(tmp_path):
    class Boom:
        shape = (1,)

        def __array__(self, *a, **k):
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        save_pytree(str(tmp_path / "x.npz"), [{"w": Boom()}])
    assert os.listdir(tmp_path) == []


def test_restored_leaves_follow_like_device(tmp_path):
    params = tae.init(torch.Generator().manual_seed(0), device="cpu")
    path = str(tmp_path / "p.npz")
    save_pytree(path, params)
    back = load_pytree(path, tae.to_numpy(params))
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for layer in back for v in layer.values())

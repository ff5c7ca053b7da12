"""Port parity for the fault layer, PyTorch vs JAX: ``core/faults`` and
the ``core/hfl`` rounds that run it.

- ``FaultConfig``: the same validation and ``is_active`` rule.
- ``byzantine_mask``: equal at several fleet sizes and fractions.
- ``corrupt_deltas``: ``sign_flip`` and ``inflate`` exactly; ``gauss`` on
  the reference's own normals exactly; ``adaptive`` (population std,
  a zero and a non-zero ``prev_delta``) to ``rtol=1e-5, atol=1e-6``
  (the mean and std sum in another order).
- crash / erasure masks from the reference's own uniforms, exactly.
- Rounds: ``gauss``, ``sign_flip`` and ``adaptive`` attacks with crash 0.2
  and erasure 0.3, under the mean, trimmed (0.3) and median reduces, at
  the quick size on the reference's draws: per-round params and every
  ``RoundMetrics`` field to ``rtol=atol=1e-5`` (``test_torch_hfl.py``'s
  tolerance), the participating sensors and ``n_erased`` exactly.  The
  ``gauss`` attack runs at the robustness benchmark's scale 20 under the
  robust reduces and at scale 5 under the mean: at 20 the mean collapses
  (loss 34 -> 5,645 in three rounds) and the reference alone then moves
  its round-3 params by 1.3e-2 when its init is scaled by 1 + 1e-7, so no
  fixed tolerance can hold two f32 implementations together there; at 5
  that response is 7e-7.
- Faults off: the draws are slice 2's draws and the round is bitwise the
  neutral fault layer's (on, every probability 0).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_hfl import (  # noqa: F401  (data is a fixture)
    E, M, N, T, assert_rounds_match, data, jax_cfg, rounds_both, torch_cfg,
)
from torch_parity import one_intra_op_thread  # noqa: F401

from repro.core import faults as jflt
from repro_torch.core import faults as tflt
from repro_torch.core import hfl as thfl
from repro_torch.core import topology as ttopo
from repro_torch.data.pipeline import multi_epoch_indices
from repro_torch.launch import experiment as texp
from repro_torch.models import autoencoder as tae


def to_torch(cfg: jflt.FaultConfig) -> tflt.FaultConfig:
    return tflt.FaultConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


CONFIGS = [
    dict(),
    dict(erasure_prob=0.2),
    dict(crash_prob=0.1),
    dict(byz_frac=0.25),
    dict(byz_mode="gauss"),
    dict(byz_mode="adaptive", byz_frac=0.0),
    dict(erasure_prob=0.0, active=True),
    dict(byz_frac=0.5, byz_mode="sign_flip", active=False),
    dict(erasure_prob=1.0, crash_prob=0.0, byz_frac=1.0),
]


@pytest.mark.parametrize("kw", CONFIGS)
def test_fault_config_activity_matches_jax(kw):
    j, t = jflt.FaultConfig(**kw), tflt.FaultConfig(**kw)
    assert t.is_active == j.is_active
    for change in (dict(erasure_prob=0.0), dict(byz_mode="inflate"), dict(byz_scale=5.0)):
        assert t.replace(**change).is_active == j.replace(**change).is_active


@pytest.mark.parametrize("kw", [
    dict(erasure_prob=-0.1), dict(crash_prob=1.5), dict(byz_frac=2.0), dict(byz_mode="krum"),
])
def test_fault_config_rejects_what_jax_rejects(kw):
    with pytest.raises(ValueError):
        jflt.FaultConfig(**kw)
    with pytest.raises(ValueError):
        tflt.FaultConfig(**kw)


@pytest.mark.parametrize("n", [1, 7, 10, 12, 200, 2000])
@pytest.mark.parametrize("frac", [0.0, 0.1, 0.25, 0.3, 0.5, 0.95, 1.0])
def test_byzantine_mask_matches_jax(n, frac):
    want = np.asarray(jflt.byzantine_mask(n, frac))
    np.testing.assert_array_equal(tflt.byzantine_mask(n, frac).numpy(), want)
    assert not want[want.sum():].any()               # a prefix of the fleet


def _deltas(seed=0, n=12, d=40):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("mode", ["none", "sign_flip", "inflate", "gauss"])
def test_corrupt_deltas_matches_jax(mode):
    deltas = _deltas()
    key = jax.random.key(3)
    cfg = jflt.FaultConfig(byz_frac=0.25, byz_scale=20.0, byz_mode=mode)
    want = np.asarray(jflt.corrupt_deltas(key, jnp.asarray(deltas), cfg))
    noise = torch.from_numpy(np.array(jax.random.normal(key, deltas.shape, jnp.float32)))
    got = tflt.corrupt_deltas(torch.from_numpy(deltas), to_torch(cfg), noise=noise).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[3:], deltas[3:])     # honest rows untouched


@pytest.mark.parametrize("prev", ["none", "zero", "nonzero"])
def test_adaptive_colluders_match_jax(prev):
    deltas = _deltas(1)
    rng = np.random.default_rng(2)
    pd = {"none": None, "zero": np.zeros(40, np.float32),
          "nonzero": rng.standard_normal(40).astype(np.float32)}[prev]
    if pd is not None:
        pd[::5] = 0.0                       # mixed: sign(mu) where prev is 0
    cfg = jflt.FaultConfig(byz_frac=0.25, byz_scale=3.0, byz_mode="adaptive")
    want = np.asarray(jflt.corrupt_deltas(
        jax.random.key(0), jnp.asarray(deltas), cfg,
        prev_delta=None if pd is None else jnp.asarray(pd)))
    got = tflt.corrupt_deltas(torch.from_numpy(deltas), to_torch(cfg),
                              prev_delta=None if pd is None else torch.from_numpy(pd)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[3:], deltas[3:])
    assert np.all(got[:3] == got[0])       # identical crafted updates


def test_crash_and_erasure_masks_match_jax():
    for i, p in enumerate((0.0, 0.2, 0.3, 0.5, 1.0)):
        key = jax.random.key(10 + i)
        u = torch.from_numpy(np.array(jax.random.uniform(key, (200,))))
        np.testing.assert_array_equal(tflt.draw_crash(u, p).numpy(),
                                      np.asarray(jflt.draw_crash(key, 200, p)))
        np.testing.assert_array_equal(tflt.draw_erasure(u, p).numpy(),
                                      np.asarray(jflt.draw_erasure(key, 200, p)))


def test_nonfinite_rows_matches_jax():
    deltas = _deltas()
    deltas[2, 3], deltas[7, 0] = np.inf, np.nan
    np.testing.assert_array_equal(tflt.nonfinite_rows(torch.from_numpy(deltas)).numpy(),
                                  np.asarray(jflt.nonfinite_rows(jnp.asarray(deltas))))


ATTACKS = {
    "gauss": dict(byz_mode="gauss", byz_frac=0.25, byz_scale=20.0),
    "sign_flip": dict(byz_mode="sign_flip", byz_frac=0.25, byz_scale=2.0),
    "adaptive": dict(byz_mode="adaptive", byz_frac=0.25, byz_scale=3.0),
}
REDUCES = {"mean": dict(), "trimmed": dict(robust="trimmed", trim_frac=0.3),
           "median": dict(robust="median")}


@pytest.mark.parametrize("reduce", list(REDUCES))
@pytest.mark.parametrize("attack", list(ATTACKS))
def test_fault_rounds_match_jax(data, attack, reduce):
    attack_kw = dict(ATTACKS[attack])
    if (attack, reduce) == ("gauss", "mean"):
        attack_kw["byz_scale"] = 5.0      # see the module docstring
    fl = jflt.FaultConfig(crash_prob=0.2, erasure_prob=0.3, **attack_kw)
    kw = REDUCES[reduce]
    both = rounds_both(data, 20, jax_cfg(faults=fl, **kw), torch_cfg(faults=to_torch(fl), **kw))
    assert_rounds_match(both)
    m_t = both[2]
    assert int(m_t.n_erased.sum()) > 0 and float(m_t.participation.min()) < 1.0


def test_faults_off_draws_are_slice_2s_and_round_is_the_neutral_layers(data):
    _, ds_t = data
    cfg = torch_cfg()
    inputs = texp.draw_trial(torch.Generator().manual_seed(5), ds_t, cfg)
    assert (inputs.draws.crash, inputs.draws.erase, inputs.draws.byz_noise) == (None,) * 3
    g = torch.Generator().manual_seed(5)
    tae.init(g, ds_t.train.shape[-1], (16, 8, 16), device="cpu")
    ttopo.sample_deployment(g, cfg.deployment, device="cpu")
    for t in range(T):            # slice 2's order: mobility noise, then index tables
        np.testing.assert_array_equal(inputs.draws.mobility[t].numpy(),
                                      torch.randn((M, 3), generator=g).numpy())
        np.testing.assert_array_equal(inputs.draws.batches[t].numpy(),
                                      multi_epoch_indices(g, N, 48, 32, E).numpy())
    neutral = cfg.replace(faults=tflt.FaultConfig(active=True))
    zeros = torch.zeros((T, N))
    draws_on = inputs.draws._replace(crash=zeros, erase=zeros)
    p_off, m_off = thfl.train(inputs.params, tae.loss, ds_t, cfg, inputs.dep, inputs.draws)
    p_on, m_on = thfl.train(inputs.params, tae.loss, ds_t, neutral, inputs.dep, draws_on)
    assert torch.equal(tae.ravel(p_off), tae.ravel(p_on))
    for a, b in zip(m_off, m_on):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="uniforms"):
        thfl.train(inputs.params, tae.loss, ds_t, neutral, inputs.dep, inputs.draws)


def test_hfl_config_validation_matches_jax():
    for bad in (dict(robust="krum"), dict(trim_frac=0.5), dict(trim_frac=-0.1),
                dict(client_chunk=0), dict(client_chunk=2.5)):
        with pytest.raises(ValueError):
            jax_cfg(**bad)
        with pytest.raises(ValueError):
            torch_cfg(**bad)
    cfg = torch_cfg(robust="median", trim_frac=0.45, client_chunk=4,
                    faults=tflt.FaultConfig(byz_mode="gauss", byz_frac=0.25))
    assert (cfg.robust, cfg.trim_frac, cfg.client_chunk, cfg.faults.is_active) == (
        "median", 0.45, 4, True)

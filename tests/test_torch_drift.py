"""Port parity for the dynamic world and the per-client compressor rounds,
PyTorch vs JAX.

- ``DriftConfig``: the same validation, ``replace`` and ``is_active``.
- ``topology.current_advection_step`` against the reference under ``jit``
  (as its round loop runs it): positions to ``rtol=1e-6, atol=1e-3`` (the
  fog walk's pin in ``test_torch_physics.py``; cos and sin round apart by
  an ulp in the two libraries), the current's phase bitwise over 200,000
  depths.
- ``association.assigned_fog_association`` / ``assigned_flat_association``
  against the reference: ids, feasibility and cluster sizes exactly,
  distances to ``rtol=1e-6``.
- Rounds at the quick size on the reference's draws (``rounds_both``):
  ``drift_bench``'s three cells (static, frozen, re-association every 2
  rounds) in its compact basin with the tight acoustic budget, a
  covariate shift of 0.1, and the per-client compressor (``fused=False``
  int8 and f32, quantise-only ``rho_s = 1``).  Per-round params and every
  ``RoundMetrics`` field to ``rtol=atol=1e-5`` (``test_torch_hfl.py``'s
  tolerance), the participating sensors exactly; in the drift cells up to
  two coordinates of a round's params may sit one int8 code apart (see
  :func:`assert_rounds_match_up_to_code_flips`).
- Drift combined with faults (``DRIFT_FAULT_CELLS``): reassociating drift
  with covariate shift 0.05, adaptive colluders, crash 0.2, erasure 0.3,
  trimmed 0.3 and ``client_chunk=5``; frozen drift with sign-flip
  colluders, median and FedAdam; reassociating drift with crash and
  erasure, the mean, ``client_chunk=5`` and FedProx 0.01.  Held as the
  drift cells, participation and erasures exactly.
- Within the port: neutral drift (on, zero rates) against drift off
  within that tolerance; ``reassoc_every=inf`` with fog mobility off
  against drift off bitwise (the frozen assignment is the per-round one
  when nothing moves).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_hfl import (  # noqa: F401  (data is a fixture)
    TOL, M, N, T, assert_metric_matches, assert_rounds_match, data, jax_cfg, jax_inputs,
    rounds_both, torch_cfg,
)
from torch_parity import one_intra_op_thread  # noqa: F401

from repro.core import association as jassoc
from repro.core import channel as jch
from repro.core import compression as jcomp
from repro.core import drift as jdrf
from repro.core import faults as jflt
from repro.core import topology as jtopo
from repro.launch import experiment as jexp
from repro_torch.core import association as tassoc
from repro_torch.core import channel as tch
from repro_torch.core import compression as tcomp
from repro_torch.core import drift as tdrf
from repro_torch.core import faults as tflt
from repro_torch.core import hfl as thfl
from repro_torch.core import topology as ttopo
from repro_torch.launch import experiment as texp
from repro_torch.models import autoencoder as tae

CURRENT, REASSOC, SL_MAX_DB = 3.0, 2.0, 135.0     # benchmarks/drift_bench.py
BASIN = dict(lx_m=1200.0, ly_m=1200.0, depth_m=400.0, sensor_depth=(200.0, 350.0),
             fog_depth=(50.0, 150.0))


def to_torch(cfg: jdrf.DriftConfig) -> tdrf.DriftConfig:
    return tdrf.DriftConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def to_torch_dep(dep):
    return ttopo.Deployment(*(torch.from_numpy(np.array(a)) for a in
                              (dep.sensor_pos, dep.fog_pos, dep.fog_vel, dep.gateway_pos)))


DRIFTS = [
    dict(),
    dict(active=True),
    dict(sensor_current_m_s=3.0),
    dict(reassoc_every=float("inf")),
    dict(reassoc_every=2.0, active=False),
    dict(covariate_shift=0.1),
    dict(sensor_current_m_s=0.0, reassoc_every=1.0, covariate_shift=0.0),
]


@pytest.mark.parametrize("kw", DRIFTS)
def test_drift_config_activity_matches_jax(kw):
    j, t = jdrf.DriftConfig(**kw), tdrf.DriftConfig(**kw)
    assert t.is_active == j.is_active
    for change in (dict(sensor_current_m_s=0.0), dict(reassoc_every=4.0), dict(active=True)):
        assert t.replace(**change).is_active == j.replace(**change).is_active
    assert to_torch(j) == t


@pytest.mark.parametrize("kw", [dict(sensor_current_m_s=-1.0), dict(reassoc_every=0.5)])
def test_drift_config_rejects_what_jax_rejects(kw):
    with pytest.raises(ValueError):
        jdrf.DriftConfig(**kw)
    with pytest.raises(ValueError):
        tdrf.DriftConfig(**kw)


def test_advection_phase_is_xla_arithmetic():
    """The phase the port computes equals the reference's jitted ``2 pi z /
    depth_m`` on every one of 200,000 depths; a true division would not."""
    depth_m = 1000.0
    z = np.random.default_rng(0).uniform(0.0, depth_m, 200_000).astype(np.float32)
    want = np.asarray(jax.jit(lambda zz: 2.0 * jnp.pi * zz / depth_m)(z))
    rate = np.float32(2.0 * math.pi) * (np.float32(1.0) / np.float32(depth_m))
    np.testing.assert_array_equal(z * rate, want)
    assert np.sum(np.float32(2.0 * math.pi) * z / np.float32(depth_m) != want) > 1000


@pytest.mark.parametrize("speed", [0.0, 3.0, 40.0])
def test_current_advection_matches_jax(speed):
    """20 steps; at 40 m/s (2.4 km a round) the sensors hit the walls."""
    params_j = jtopo.DeploymentParams(n_sensors=200, n_fog=20, **BASIN)
    params_t = ttopo.DeploymentParams(n_sensors=200, n_fog=20, **BASIN)
    dep_j = jtopo.sample_deployment(jax.random.key(3), params_j)
    step = jax.jit(lambda dep: jtopo.current_advection_step(dep, params_j, speed))
    dep_t = to_torch_dep(dep_j)
    for _ in range(20):
        dep_j = step(dep_j)
        new_t = ttopo.current_advection_step(dep_t, params_t, speed)
        np.testing.assert_allclose(new_t.sensor_pos.numpy(), np.asarray(dep_j.sensor_pos),
                                   rtol=1e-6, atol=1e-3)
        assert new_t.fog_pos is dep_t.fog_pos and new_t.fog_vel is dep_t.fog_vel
        dep_t = to_torch_dep(dep_j)
    pos = dep_t.sensor_pos.numpy()
    assert (pos >= [0.0, 0.0, 200.0]).all() and (pos <= [1200.0, 1200.0, 350.0]).all()
    if speed == 0.0:
        np.testing.assert_array_equal(pos, np.asarray(
            jtopo.sample_deployment(jax.random.key(3), params_j).sensor_pos))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assigned_association_matches_jax(seed):
    """A frozen assignment from one deployment meets a moved one."""
    cj, ct = jch.ChannelParams().replace(sl_max_db=SL_MAX_DB), tch.ChannelParams().replace(
        sl_max_db=SL_MAX_DB)
    params_j = jtopo.DeploymentParams(n_sensors=200, n_fog=20, **BASIN)
    dep0 = jtopo.sample_deployment(jax.random.key(seed), params_j)
    frozen = jassoc.nearest_feasible_fog(dep0, cj)
    dep1 = dep0
    for _ in range(3):
        dep1 = jtopo.current_advection_step(dep1, params_j, 40.0)
    dep_t = to_torch_dep(dep1)
    fj = jassoc.assigned_fog_association(dep1, cj, frozen.fog_id, frozen.participates)
    ft = tassoc.assigned_fog_association(dep_t, ct, torch.from_numpy(np.array(frozen.fog_id)),
                                         torch.from_numpy(np.array(frozen.participates)))
    for name in ("fog_id", "participates", "cluster_size", "fog_gateway_feasible"):
        np.testing.assert_array_equal(getattr(ft, name).numpy(), np.asarray(getattr(fj, name)))
    assert ft.fog_id.dtype == torch.int32
    np.testing.assert_allclose(ft.dist_m.numpy(), np.asarray(fj.dist_m), rtol=1e-6)
    assert ft.participates.sum() < int(np.sum(frozen.participates))   # links were lost
    gj = jassoc.assigned_flat_association(dep1, cj, frozen.participates)
    gt = tassoc.assigned_flat_association(dep_t, ct, torch.from_numpy(np.array(
        frozen.participates)))
    np.testing.assert_array_equal(gt.participates.numpy(), np.asarray(gj.participates))
    np.testing.assert_allclose(gt.dist_m.numpy(), np.asarray(gj.dist_m), rtol=1e-6)


def test_fresh_assignment_is_the_nearest_feasible_association():
    ct = tch.ChannelParams().replace(sl_max_db=SL_MAX_DB)
    params = ttopo.DeploymentParams(n_sensors=200, n_fog=20, **BASIN)
    dep = ttopo.sample_deployment(torch.Generator().manual_seed(0), params, device="cpu")
    fresh = tassoc.nearest_feasible_fog(dep, ct)
    again = tassoc.assigned_fog_association(dep, ct, fresh.fog_id, fresh.participates)
    for a, b in zip(fresh, again):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _world(ch_mod, topo_mod):
    return dict(deployment=topo_mod.DeploymentParams(n_sensors=N, n_fog=M, **BASIN),
                channel=ch_mod.ChannelParams().replace(sl_max_db=SL_MAX_DB))


DRIFT_CELLS = {
    "static": dict(active=True),
    "frozen": dict(sensor_current_m_s=CURRENT, reassoc_every=float("inf")),
    "reassoc": dict(sensor_current_m_s=CURRENT, reassoc_every=REASSOC),
}


def _drift_cfgs(cell):
    kw = DRIFT_CELLS[cell]
    cfg_j = jax_cfg(**_world(jch, jtopo), drift=jdrf.DriftConfig(**kw))
    cfg_t = torch_cfg(**_world(tch, ttopo), drift=tdrf.DriftConfig(**kw))
    return cfg_j, cfg_t


@pytest.fixture(scope="module")
def drift_rounds(data):
    return {cell: rounds_both(data, 30, *_drift_cfgs(cell)) for cell in DRIFT_CELLS}


def assert_rounds_match_up_to_code_flips(both, max_flips=2, step=1e-3):
    """:func:`assert_rounds_match`, except that up to ``max_flips``
    coordinates of a round's params may differ by up to ``step``.

    The reference's jitted error feedback computes ``v - q * scale`` as a
    fused multiply-add and the port does not (``test_torch_compress.py``),
    so the two error buffers part by an ulp after round 0; once in a few
    hundred rounds that ulp moves some ``v / scale`` across a rounding
    half-step (or a magnitude across the Top-K threshold), and one int8
    code of one client differs by 1.  That moves one coordinate of the
    global params by at most one quantisation step, block max / 127, times
    the client's share of its fog and its fog's share of the gateway mean:
    max |v| is below 0.04 in these rounds, so a step is below 3.2e-4.
    Everything else holds to ``TOL``."""
    m_j, rounds_j, m_t, rounds_t, p_t = both
    for pj, pt in zip(rounds_j, rounds_t):
        got, want = tae.ravel(pt).numpy(), tae.ravel(pj).numpy()
        off = ~np.isclose(got, want, **TOL)
        assert off.sum() <= max_flips and np.all(np.abs(got - want)[off] <= step)
    np.testing.assert_array_equal(tae.ravel(p_t).numpy(), tae.ravel(rounds_t[-1]).numpy())
    for field in thfl.RoundMetrics._fields:
        assert_metric_matches(field, getattr(m_t, field).numpy(), np.asarray(getattr(m_j, field)))


@pytest.mark.parametrize("cell", list(DRIFT_CELLS))
def test_drift_cell_rounds_match_jax(drift_rounds, cell):
    assert_rounds_match_up_to_code_flips(drift_rounds[cell])


# Drift combined with faults, the robust reduces, client chunks and the
# server and local optimisers: (drift cell, covariate shift, faults, round
# options).
DRIFT_FAULT_CELLS = {
    "reassoc-adaptive-trimmed-chunked": (
        "reassoc", 0.05,
        dict(byz_mode="adaptive", byz_frac=0.25, byz_scale=3.0, crash_prob=0.2,
             erasure_prob=0.3),
        dict(robust="trimmed", trim_frac=0.3, client_chunk=5)),
    "frozen-sign_flip-median-adam": (
        "frozen", 0.0, dict(byz_mode="sign_flip", byz_frac=0.25, byz_scale=2.0),
        dict(robust="median", server_opt="adam")),
    "reassoc-crash-erasure-mean-chunked-prox": (
        "reassoc", 0.0, dict(crash_prob=0.2, erasure_prob=0.3),
        dict(client_chunk=5, prox_mu=0.01)),
}


@pytest.mark.parametrize("name", list(DRIFT_FAULT_CELLS))
def test_drift_with_faults_rounds_match_jax(data, name):
    """Participation and erasures exactly, the rest as the drift cells."""
    cell, shift, faults, kw = DRIFT_FAULT_CELLS[name]
    drift = dict(DRIFT_CELLS[cell], covariate_shift=shift)
    fl = jflt.FaultConfig(**faults)
    cfg_j = jax_cfg(**_world(jch, jtopo), drift=jdrf.DriftConfig(**drift), faults=fl, **kw)
    cfg_t = torch_cfg(**_world(tch, ttopo), drift=tdrf.DriftConfig(**drift),
                      faults=tflt.FaultConfig(**faults), **kw)
    both = rounds_both(data, 70, cfg_j, cfg_t)
    assert_rounds_match_up_to_code_flips(both)
    m_j, m_t = both[0], both[2]
    np.testing.assert_array_equal(np.round(m_t.participation.numpy() * N),
                                  np.round(np.asarray(m_j.participation) * N))
    np.testing.assert_array_equal(m_t.n_erased.numpy(), np.asarray(m_j.n_erased))
    if "erasure_prob" in faults:
        assert int(m_t.n_erased.sum()) > 0


def test_reassociation_keeps_at_least_the_frozen_cohort(drift_rounds):
    """On the same draws the geometry of the frozen and the re-associated
    cells is the same; in a re-association round (0 and 2) the nearest
    feasible fog is feasible wherever the stale one is, so those rounds
    keep at least the frozen cell's sensors (equal at round 0)."""
    part = {cell: r[2].participation.numpy() for cell, r in drift_rounds.items()}
    assert part["frozen"][0] == part["reassoc"][0]
    assert part["frozen"][2] <= part["reassoc"][2]


def test_covariate_shift_rounds_match_jax(data):
    cfg_j = jax_cfg().replace(drift=jdrf.DriftConfig(covariate_shift=0.1))
    cfg_t = torch_cfg().replace(drift=tdrf.DriftConfig(covariate_shift=0.1))
    both = rounds_both(data, 40, cfg_j, cfg_t)
    assert_rounds_match(both)
    off = rounds_both(data, 40, jax_cfg(), torch_cfg())
    assert not np.array_equal(both[2].loss.numpy()[1:], off[2].loss.numpy()[1:])
    np.testing.assert_array_equal(both[2].loss.numpy()[0], off[2].loss.numpy()[0])
    np.testing.assert_array_equal(both[2].participation.numpy(), off[2].participation.numpy())


COMPRESSORS = {
    "unfused-int8": dict(fused=False),
    "unfused-f32": dict(fused=False, quant_bits=32),
    "dense-int8": dict(rho_s=1.0),
}


@pytest.mark.parametrize("name", list(COMPRESSORS))
def test_per_client_compressor_rounds_match_jax(data, name):
    kw = COMPRESSORS[name]
    cfg_j = jax_cfg().replace(compressor=jcomp.CompressorConfig(
        rho_s=0.05, quant_bits=8, mode="blockwise").replace(**kw))
    cfg_t = torch_cfg().replace(compressor=tcomp.CompressorConfig(**kw))
    assert_rounds_match(rounds_both(data, 50, cfg_j, cfg_t))


@pytest.mark.parametrize("name,cell", [("unfused-int8", None), (None, "reassoc")])
def test_trial_metrics_match_jax(data, name, cell):
    ds, ds_t = data
    if cell is None:
        cfg_j = jax_cfg().replace(compressor=jcomp.CompressorConfig(
            rho_s=0.05, quant_bits=8, mode="blockwise", fused=False))
        cfg_t = torch_cfg().replace(compressor=tcomp.CompressorConfig(fused=False))
    else:
        cfg_j, cfg_t = _drift_cfgs(cell)
    key = jax.random.key(60)
    _, inputs = jax_inputs(key, ds, cfg_j)
    want = jexp.trial_metrics("hfl-selective", key, ds, cfg_j)
    got = texp.trial_metrics("hfl-selective", None, ds_t, cfg_t, inputs=inputs, device="cpu")
    assert set(want) == set(got)
    for k in ("coop_links", "nonfinite_total", "erased_total", "nonfinite_rounds"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("participation", "e_total", "e_s2f", "e_f2f", "e_f2g", "losses", "sim_time_s",
              "f1", "precision", "recall"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL, err_msg=k)


def _port_rounds(data, cfg, seed=3):
    _, ds_t = data
    inputs = texp.draw_trial(torch.Generator().manual_seed(seed), ds_t, cfg)
    return thfl.train(inputs.params, tae.loss, ds_t, cfg, inputs.dep, inputs.draws)


def test_neutral_drift_matches_drift_off(data):
    cfg = torch_cfg()
    p_off, m_off = _port_rounds(data, cfg)
    p_on, m_on = _port_rounds(data, cfg.replace(drift=tdrf.DriftConfig(active=True)))
    np.testing.assert_allclose(tae.ravel(p_on).numpy(), tae.ravel(p_off).numpy(), **TOL)
    for field in thfl.RoundMetrics._fields:
        np.testing.assert_allclose(getattr(m_on, field).numpy(), getattr(m_off, field).numpy(),
                                   **TOL, err_msg=field)
    np.testing.assert_array_equal(m_on.participation.numpy(), m_off.participation.numpy())


def test_frozen_assignment_is_a_noop_in_a_static_world(data):
    cfg = torch_cfg(fog_mobility=False)
    p_off, m_off = _port_rounds(data, cfg)
    p_on, m_on = _port_rounds(data, cfg.replace(drift=tdrf.DriftConfig(
        reassoc_every=float("inf"))))
    np.testing.assert_array_equal(tae.ravel(p_on).numpy(), tae.ravel(p_off).numpy())
    for a, b in zip(m_on, m_off):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_drift_draws_nothing_and_make_config_passes_it(data):
    _, ds_t = data
    drift = tdrf.DriftConfig(sensor_current_m_s=CURRENT, reassoc_every=REASSOC)
    cfg = texp.make_config(N, M, T, local_epochs=1, drift=drift)
    assert cfg.drift == drift and cfg.drift.is_active
    a = texp.draw_trial(torch.Generator().manual_seed(8), ds_t, cfg)
    b = texp.draw_trial(torch.Generator().manual_seed(8), ds_t, cfg.replace(
        drift=tdrf.DriftConfig()))
    for x, y in zip(a.draws, b.draws):
        assert (x is None and y is None) or torch.equal(x, y)

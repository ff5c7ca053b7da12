"""Port parity for the physics of a round, PyTorch vs JAX: channel, energy,
topology, association, cooperation, and the training-free audit replay.

Geometries and noise are drawn with ``jax.random`` and handed to both
packages.  Booleans, fog ids and partner ids agree exactly; energies and
other f32 quantities to ``rtol=1e-5`` (both packages compute in f32, in
possibly different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import one_intra_op_thread  # noqa: F401

from repro.core import association as jassoc
from repro.core import channel as jch
from repro.core import cooperation as jcoop
from repro.core import energy as jen
from repro.core import topology as jtopo
from repro.launch import experiment as jexp
from repro_torch.core import association as tassoc
from repro_torch.core import channel as tch
from repro_torch.core import cooperation as tcoop
from repro_torch.core import energy as ten
from repro_torch.core import topology as ttopo
from repro_torch.launch import experiment as texp

CH_J, CH_T = jch.ChannelParams(), tch.ChannelParams()
EN_J, EN_T = jen.EnergyParams(), ten.EnergyParams()
DISTS = np.array([0.2, 1.0, 37.5, 400.0, 1250.0, 2900.0, 4100.0, 9000.0], np.float32)


def close(got, want, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def to_torch_dep(dep):
    return ttopo.Deployment(*(torch.from_numpy(np.array(a)) for a in
                              (dep.sensor_pos, dep.fog_pos, dep.fog_vel, dep.gateway_pos)))


def jax_dep(seed, n=200, m=20):
    params = jtopo.DeploymentParams(n_sensors=n, n_fog=m)
    return jtopo.sample_deployment(jax.random.key(seed), params), params


@pytest.mark.parametrize("freq_khz", [1.0, 12.0, 40.0])
def test_channel_matches_jax(freq_khz):
    cj, ct = CH_J.replace(freq_khz=freq_khz), CH_T.replace(freq_khz=freq_khz)
    d = torch.from_numpy(DISTS)
    close(tch.thorp_absorption_db_per_km(freq_khz), jch.thorp_absorption_db_per_km(freq_khz))
    close(tch.transmission_loss_db(d, freq_khz, 1.7),
          jch.transmission_loss_db(DISTS, freq_khz, 1.7))
    close(tch.wenz_noise_psd_db(freq_khz, 7.0, 0.8), jch.wenz_noise_psd_db(freq_khz, 7.0, 0.8))
    close(tch.noise_level_db(ct), jch.noise_level_db(cj))
    close(tch.snr_db(150.0, d, ct), jch.snr_db(150.0, DISTS, cj))
    close(tch.min_source_level_db(d, ct), jch.min_source_level_db(DISTS, cj))
    np.testing.assert_array_equal(tch.feasible(d, ct).numpy(), np.asarray(jch.feasible(DISTS, cj)))
    close(tch.shannon_rate_bps(ct), jch.shannon_rate_bps(cj))
    close(tch.propagation_delay_s(d), jch.propagation_delay_s(DISTS))
    close(tch.max_feasible_range_m(ct), jch.max_feasible_range_m(cj))


def test_pairwise_distances_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 2000, (30, 3)).astype(np.float32)
    b = rng.uniform(0, 2000, (7, 3)).astype(np.float32)
    close(tch.pairwise_distances(torch.from_numpy(a), torch.from_numpy(b)),
          jch.pairwise_distances(a, b), rtol=1e-6)


def test_energy_matches_jax():
    d = torch.from_numpy(DISTS)
    sl = jch.min_source_level_db(DISTS, CH_J)
    close(ten.acoustic_power_w(torch.from_numpy(np.array(sl))), jen.acoustic_power_w(sl))
    for bits in (43264.0, 1632.0):
        e_t = ten.tx_energy_j(bits, d, CH_T, EN_T).numpy()
        e_j = np.asarray(jen.tx_energy_j(bits, DISTS, CH_J, EN_J))
        np.testing.assert_array_equal(np.isinf(e_t), np.isinf(e_j))
        assert np.isinf(e_t).any() and np.isfinite(e_t).any()
        close(e_t[np.isfinite(e_j)], e_j[np.isfinite(e_j)])
        close(ten.rx_energy_j(bits, CH_T, EN_T), jen.rx_energy_j(bits, CH_J, EN_J))
        close(ten.link_latency_s(bits, d, CH_T), jen.link_latency_s(bits, DISTS, CH_J))
    close(ten.compute_energy_j(3.3e7, EN_T), jen.compute_energy_j(jnp.float32(3.3e7), EN_J))
    res = np.array([5.0, 0.5, 0.0], np.float32)
    spent = np.array([1.0, 1.0, 0.0], np.float32)
    bt, at = ten.battery_step(torch.from_numpy(res), torch.from_numpy(spent), EN_T)
    bj, aj = jen.battery_step(res, spent, EN_J)
    close(bt, bj)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert ten.autoencoder_flops(32, (16, 8, 16), 256, 5) == jen.autoencoder_flops(
        32, (16, 8, 16), 256, 5)


@pytest.mark.parametrize("speed", [0.5, 8.0])
def test_gauss_markov_walk_matches_jax_with_injected_noise(speed):
    """20 steps; at 8 m/s the fogs hit the walls and reflect."""
    dep_j, params_j = jax_dep(1, n=10, m=20)
    params_j = params_j.replace(fog_speed_m_s=speed)
    params_t = ttopo.DeploymentParams(n_sensors=10, n_fog=20, fog_speed_m_s=speed)
    dep_t = to_torch_dep(dep_j)
    key = jax.random.key(7)
    flips = 0
    for _ in range(20):
        key, k = jax.random.split(key)
        noise = np.array(jax.random.normal(k, (20, 3)))
        new_j = jtopo.gauss_markov_step(k, dep_j, params_j)
        new_t = ttopo.gauss_markov_step(torch.from_numpy(noise), dep_t, params_t)
        flips += int(np.sum(np.sign(np.asarray(new_j.fog_vel))
                            != np.sign(np.asarray(dep_j.fog_vel))))
        close(new_t.fog_pos, new_j.fog_pos, rtol=1e-6, atol=1e-3)
        close(new_t.fog_vel, new_j.fog_vel, rtol=1e-5, atol=1e-6)
        dep_j, dep_t = new_j, ttopo.Deployment(dep_t.sensor_pos, torch.from_numpy(
            np.array(new_j.fog_pos)), torch.from_numpy(np.array(new_j.fog_vel)), dep_t.gateway_pos)
    lo = np.array([0.0, 0.0, 100.0])
    hi = np.array([2000.0, 2000.0, 400.0])
    pos = dep_t.fog_pos.numpy()
    assert ((pos >= lo) & (pos <= hi)).all() and flips > 0


def test_sample_deployment_draws_inside_the_strata():
    params = ttopo.DeploymentParams(n_sensors=300, n_fog=30)
    dep = ttopo.sample_deployment(torch.Generator().manual_seed(0), params, device="cpu")
    s, f = dep.sensor_pos.numpy(), dep.fog_pos.numpy()
    assert s.shape == (300, 3) and f.shape == (30, 3) and dep.fog_vel.abs().sum() == 0
    assert (s[:, :2] >= 0).all() and (s[:, :2] <= 2000).all()
    assert (s[:, 2] >= 500).all() and (s[:, 2] <= 1000).all()
    assert (f[:, 2] >= 100).all() and (f[:, 2] <= 400).all()
    np.testing.assert_array_equal(dep.gateway_pos.numpy(), [1000.0, 1000.0, 0.0])
    again = ttopo.sample_deployment(torch.Generator().manual_seed(0), params, device="cpu")
    np.testing.assert_array_equal(again.sensor_pos.numpy(), s)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_association_matches_jax(seed):
    # A short source-level cap leaves some sensors without a feasible fog.
    cj, ct = CH_J.replace(sl_max_db=134.0), CH_T.replace(sl_max_db=134.0)
    dep_j, _ = jax_dep(seed)
    dep_t = to_torch_dep(dep_j)
    fj, ft = jassoc.nearest_feasible_fog(dep_j, cj), tassoc.nearest_feasible_fog(dep_t, ct)
    for name in ("fog_id", "participates", "cluster_size", "fog_gateway_feasible"):
        np.testing.assert_array_equal(getattr(ft, name).numpy(), np.asarray(getattr(fj, name)))
    assert ft.fog_id.dtype == torch.int32
    assert not ft.participates.all() and ft.participates.any()
    close(ft.dist_m, fj.dist_m, rtol=1e-6)
    close(ft.fog_gateway_dist_m, fj.fog_gateway_dist_m, rtol=1e-6)
    gj, gt = jassoc.flat_association(dep_j, cj), tassoc.flat_association(dep_t, ct)
    np.testing.assert_array_equal(gt.participates.numpy(), np.asarray(gj.participates))
    close(gt.dist_m, gj.dist_m, rtol=1e-6)


@pytest.mark.parametrize("rule", list(jcoop.CoopRule))
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_cooperation_rules_match_jax(rule, seed):
    dep_j, _ = jax_dep(seed, n=10, m=20)
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 12, 20).astype(np.int32)
    sizes[rng.integers(0, 20, 4)] = 0                 # empty fogs
    cj, ct = CH_J.replace(sl_max_db=131.0), CH_T.replace(sl_max_db=131.0)
    dj = jcoop.decide(rule, dep_j.fog_pos, jnp.asarray(sizes), cj)
    dt = tcoop.decide(tcoop.CoopRule(rule.value), torch.from_numpy(np.array(dep_j.fog_pos)),
                      torch.from_numpy(sizes), ct)
    for name in ("partner", "cooperates", "self_weight", "partner_weight"):
        np.testing.assert_array_equal(getattr(dt, name).numpy(), np.asarray(getattr(dj, name)))
    close(dt.dist_m, dj.dist_m, rtol=1e-6)


def test_selective_rule_degrades_to_no_coop_without_feasible_pairs():
    dep_j, _ = jax_dep(0, n=10, m=6)
    ct = CH_T.replace(sl_max_db=60.0)                # nothing is feasible
    dt = tcoop.decide(tcoop.CoopRule.SELECTIVE, torch.from_numpy(np.array(dep_j.fog_pos)),
                      torch.arange(6, dtype=torch.int32), ct)
    assert not dt.cooperates.any()
    np.testing.assert_array_equal(dt.partner.numpy(), np.arange(6))


@pytest.mark.parametrize("method", ["hfl-selective", "fedavg"])
def test_audit_trial_matches_jax_at_paper_scale(method):
    """N = 200 sensors, M = 20 fogs, T = 20 rounds; the reference draws the
    deployment from the key and each round's mobility noise from
    ``split(fold_in(key, 1), T)``, which is what the port is handed."""
    cfg_j = jexp.make_config(n_sensors=200, n_fog=20, rounds=20)
    cfg_t = texp.make_config(n_sensors=200, n_fog=20, rounds=20)
    key = jax.random.key(3)
    dep = jtopo.sample_deployment(key, cfg_j.deployment)
    keys = jax.random.split(jax.random.fold_in(key, 1), 20)
    noise = np.stack([np.array(jax.random.normal(k, (20, 3))) for k in keys])
    want = jexp.audit_trial(method, key, cfg_j, d=1352)
    got = texp.audit_trial(method, cfg_t, to_torch_dep(dep), torch.from_numpy(noise), d=1352)
    assert set(got) == set(want)
    for name in ("e_s2f", "e_f2f", "e_f2g", "e_total"):
        close(got[name], want[name])
    close(got["participation"], want["participation"], rtol=1e-6)
    close(got["coop_links"], want["coop_links"], rtol=1e-6)
    if method == "hfl-selective":
        assert float(got["coop_links"]) > 0 and float(got["e_f2f"]) > 0

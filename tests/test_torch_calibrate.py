"""Port parity: streaming threshold calibration, PyTorch port vs JAX.

Below capacity a reservoir holds every error, so the port's thresholds
equal ``repro.serving.calibrate.threshold`` (per fog and global) to
``rtol=1e-6``.  Past capacity the two packages draw different (equally
uniform) replacement slots, so the port is held to the JAX test's bound:
within 5% of the stream percentile.  The PSI drift signal depends only on
the finite error stream and equals JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import one_intra_op_thread  # noqa: F401

from repro.serving import StreamingCalibrator as JaxCalibrator
from repro.serving import calibrate as jcal
from repro_torch.serving import StreamingCalibrator
from repro_torch.serving import calibrate as tcal


def _errors(n, seed, scale=3.0):
    return (np.random.default_rng(seed).uniform(size=n) * scale).astype(np.float32)


@pytest.mark.parametrize("percentile", [99.0, 50.0, 90.0])
def test_thresholds_equal_jax_below_capacity_per_fog_and_global(percentile):
    errs = _errors(900, 0)
    fog = (np.arange(900) % 4).astype(np.int32)
    fog[::7] = 2                                   # unequal group sizes
    jc = JaxCalibrator(capacity=1024, n_fog=5, percentile=percentile)
    tc = StreamingCalibrator(capacity=1024, n_fog=5, percentile=percentile)
    for i in range(3):                             # three streaming batches
        sl = slice(i * 300, (i + 1) * 300)
        jc.observe(jnp.asarray(errs[sl]), jnp.asarray(fog[sl]))
        tc.observe(torch.from_numpy(errs[sl]), fog[sl])
    tj, tt = np.asarray(jc.taus()), tc.taus().numpy()
    assert tt.dtype == np.float32 and tt.shape == (6,)
    np.testing.assert_allclose(tt, tj, rtol=1e-6)
    assert np.isinf(tt[4])                         # fog 4 saw nothing
    np.testing.assert_allclose(
        float(tc.global_tau), np.percentile(errs, percentile), rtol=1e-6
    )
    np.testing.assert_array_equal(tc.state.count, np.asarray(jc.state.count))
    assert tc.seen == jc.seen == 900


def test_nonfinite_errors_excluded_like_jax():
    finite = _errors(80, 2)
    errs = np.concatenate([finite[:40], [np.nan, np.inf, -np.inf], finite[40:]]).astype(
        np.float32
    )
    tc = StreamingCalibrator(capacity=256, percentile=99.0)
    tc.observe(errs)
    assert tc.seen == 80
    np.testing.assert_allclose(
        float(tc.global_tau), float(jnp.percentile(finite, 99.0)), rtol=1e-6
    )
    tc2 = StreamingCalibrator(capacity=64, n_fog=2, percentile=50.0)
    jc2 = JaxCalibrator(capacity=64, n_fog=2, percentile=50.0)
    e2, f2 = np.asarray([1.0, np.nan, 3.0], np.float32), np.asarray([0, 0, 1])
    tc2.observe(e2, f2)
    jc2.observe(jnp.asarray(e2), jnp.asarray(f2, jnp.int32))
    np.testing.assert_allclose(tc2.taus().numpy(), np.asarray(jc2.taus()), rtol=1e-6)
    np.testing.assert_array_equal(tc2.state.count, [1, 1, 2])


def test_converges_beyond_capacity():
    big = _errors(20000, 1, scale=1.0)
    tc = StreamingCalibrator(capacity=2048, percentile=99.0, seed=1)
    for i in range(20):
        tc.observe(big[i * 1000 : (i + 1) * 1000])
    assert tc.seen == 20000
    t_oneshot = float(np.percentile(big, 99.0))
    assert abs(float(tc.global_tau) - t_oneshot) / t_oneshot < 0.05


def test_decayed_horizon_tracks_a_shift_uniform_does_not():
    """With ``horizon`` the reservoir forgets the pre-shift world; the
    uniform (LEGACY_HORIZON) reservoir stays anchored to it."""
    before, after = _errors(9000, 3, 1.0), 10.0 + _errors(3000, 4, 1.0)
    uniform = StreamingCalibrator(capacity=512, percentile=50.0, seed=0)
    decayed = StreamingCalibrator(capacity=512, percentile=50.0, seed=0, horizon=1024)
    for c in (uniform, decayed):
        c.observe(before)
        c.observe(after)
    assert float(decayed.global_tau) > 10.0
    assert float(uniform.global_tau) < 10.0
    assert uniform.state.horizon == tcal.LEGACY_HORIZON == jcal.LEGACY_HORIZON


def test_replacement_draws_come_from_the_generator():
    """Same seed -> same reservoir; another seed -> another sample."""
    errs = _errors(5000, 5)
    a, b, c = (StreamingCalibrator(capacity=256, seed=s) for s in (7, 7, 8))
    for cal in (a, b, c):
        cal.observe(errs)
    np.testing.assert_array_equal(a.state.buffer, b.state.buffer)
    assert not np.array_equal(a.state.buffer, c.state.buffer)


def test_psi_equals_jax():
    rng = np.random.default_rng(6)
    stream = [rng.uniform(size=300).astype(np.float32) for _ in range(3)]
    stream += [(2.0 + rng.uniform(size=300)).astype(np.float32) for _ in range(3)]
    jc = JaxCalibrator(capacity=4096, psi_window=512)
    tc = StreamingCalibrator(capacity=4096, psi_window=512)
    psis = []
    for batch in stream:
        jc.observe(jnp.asarray(batch))
        tc.observe(batch)
        psis.append((tc.psi(), jc.psi()))
    for pt, pj in psis:
        assert pt == pytest.approx(pj, rel=1e-12, abs=1e-12)
    assert psis[0][0] == 0.0 and psis[-1][0] > 0.25


def test_empty_reservoir_is_inf():
    state = tcal.init(torch.Generator().manual_seed(0), capacity=16, n_fog=2)
    assert np.all(np.isinf(tcal.threshold(state).numpy()))
    jstate = jcal.init(jax.random.key(0), capacity=16, n_fog=2)
    np.testing.assert_array_equal(
        tcal.threshold(state).numpy(), np.asarray(jcal.threshold(jstate))
    )


def test_functional_update_leaves_input_state_unchanged():
    state = tcal.init(torch.Generator().manual_seed(0), capacity=8, n_fog=1)
    new = tcal.update(state, np.asarray([1.0, 2.0], np.float32), np.asarray([0, 0]))
    assert state.count.tolist() == [0, 0] and new.count.tolist() == [2, 2]

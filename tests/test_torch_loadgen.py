"""Port parity: the load generator is a numpy-only copy of ``repro.loadgen``.

Identical arguments give identical arrays in both packages, and the
port's replay harness drives the port's services.
"""
import numpy as np
import pytest

from repro.loadgen import diurnal_trace as j_diurnal
from repro.loadgen import gaussian_windows as j_windows
from repro.loadgen import mmpp_trace as j_mmpp
from repro.loadgen import poisson_trace as j_poisson
from repro_torch.loadgen import (
    VirtualClock,
    diurnal_trace,
    gaussian_windows,
    mmpp_trace,
    poisson_trace,
)

TRACES = [
    (poisson_trace, j_poisson, dict(rate_hz=250.0, duration_s=3.0, fleet=64, n_fog=4)),
    (mmpp_trace, j_mmpp, dict(rate_on_hz=2000.0, mean_on_s=0.3, mean_off_s=0.5,
                              duration_s=3.0, fleet=64, n_fog=4, rows=16)),
    (diurnal_trace, j_diurnal, dict(base_rate_hz=20.0, peak_rate_hz=200.0, period_s=2.0,
                                    duration_s=4.0, fleet=200, n_fog=20, rows=8)),
]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("port,ref,kw", TRACES)
def test_traces_identical_to_jax_package(port, ref, kw, seed):
    a, b = port(seed, **kw), ref(seed, **kw)
    assert a.kind == b.kind and a.rows == b.rows and a.duration_s == b.duration_s
    np.testing.assert_array_equal(a.t, b.t)
    np.testing.assert_array_equal(a.sensor, b.sensor)
    np.testing.assert_array_equal(a.fog, b.fog)
    assert a.summary() == b.summary()


def test_gaussian_windows_identical():
    tr = poisson_trace(1, rate_hz=100.0, duration_s=1.0, fleet=8, n_fog=2)
    wa, wb = gaussian_windows(tr, 32, seed=4), j_windows(tr, 32, seed=4)
    for i in (0, 5, tr.n_events - 1):
        np.testing.assert_array_equal(wa(i), wb(i))


def test_virtual_clock_is_monotonic():
    c = VirtualClock(1.0)
    c.advance(0.5)
    c.advance_to(1.2)
    assert c() == 1.5
    c.advance_to(2.0)
    assert c() == 2.0

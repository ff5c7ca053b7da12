"""The slice as a whole: one request sequence through a JAX service and a
port service (``device="cpu"``), both restoring from the same JAX-written
checkpoint store.

The sequence exercises the 128/1024 buckets, ``max_wait_s`` deadline
flushes, a per-fog streaming calibrator fed by ``ingest_validation``,
``max_queue`` admission control, a mid-stream publish + ``poll()``
hot-swap, ``tick`` and ``drain``.  Both services read a hand-driven clock
(no ``advance``), so their flush decisions cannot depend on measured
time.  Per-request errors agree to ``rtol=1e-5, atol=1e-5``, flags and
the calibrator's thresholds (below capacity) agree, and every
``ServiceStats`` counter is equal.
"""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointStore as JaxStore
from repro.models import autoencoder as jae
from repro.serving import MultiTenantService as JaxMulti
from repro.serving import ScoringService as JaxService
from repro.serving import StreamingCalibrator as JaxCalibrator
from repro_torch.checkpoint import CheckpointStore
from repro_torch.loadgen import VirtualClock, mmpp_trace, replay
from repro_torch.models import autoencoder as tae
from repro_torch.serving import (
    MultiTenantService,
    ScorePrograms,
    ScoringService,
    StreamingCalibrator,
)

BUCKETS = (128, 1024)
MAX_WAIT_S = 0.02
N_FOG = 3
COUNTERS = ("requests", "samples", "steps", "swaps", "partial_flushes", "dropped",
            "compiles_by_bucket")


class HandClock:
    """A clock only the test moves (no ``advance``: step times are ignored)."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _params(seed=0):
    return jae.init(jax.random.key(seed), 32, (16, 8, 16))


def _rows(rng, *shape):
    return (1.5 * rng.standard_normal((*shape, 32))).astype(np.float32)


def _script(rng):
    """(op, args) list: the request sequence both services replay."""
    return [
        ("ingest", (_rows(rng, 8, 24), (np.arange(8) % N_FOG)[:, None])),
        ("submit", (_rows(rng, 10), 0)),
        ("advance", 0.01), ("pump", None),                 # not due yet
        ("submit", (_rows(rng, 4, 48), 1)),
        ("advance", 0.015), ("pump", None),                # deadline -> 1024 partial
        ("submit", (_rows(rng, 1100), 2)), ("pump", None),  # full 1024 + 76 left
        ("advance", 0.03), ("pump", None),                 # 76 rows -> 128 partial
        *[("submit", (_rows(rng, 5), i % N_FOG)) for i in range(10)],  # 2 dropped
        ("pump", None), ("advance", 0.03), ("pump", None),
        ("publish", 0.5), ("poll", None),
        ("submit", (_rows(rng, 50), None)),
        ("submit", (_rows(rng, 3, 40), 2)),
        ("advance", 0.05), ("tick", None),
        ("submit", (_rows(rng, 300), 1)),
        ("drain", None),
    ]


def _replay(svc, clock, script, publish, submit):
    out = {"results": {}, "ingest": None}
    for op, arg in script:
        if op == "ingest":
            out["ingest"] = np.asarray(svc.ingest_validation(*arg))
        elif op == "submit":
            submit(svc, *arg)
        elif op == "advance":
            clock.now += arg
        elif op == "pump":
            svc.pump()
        elif op == "tick":
            svc.tick()
        elif op == "poll":
            out["poll"] = svc.poll()
        elif op == "publish":
            publish(arg)
        elif op == "drain":
            out["results"].update(svc.drain())
    return out


def _assert_same_results(rt, rj):
    assert set(rt) == set(rj) and len(rt) > 0
    for key in rj:
        et, ej = np.asarray(rt[key].error), np.asarray(rj[key].error)
        assert et.shape == ej.shape
        np.testing.assert_allclose(et, ej, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(rt[key].flag), np.asarray(rj[key].flag))


def _assert_same_stats(st, sj):
    for name in COUNTERS:
        assert getattr(st, name) == getattr(sj, name), name
    assert st.psi == pytest.approx(sj.psi, rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("weight_dtype", ["f32", "int8"])
def test_service_matches_jax_service(tmp_path, weight_dtype):
    pj = _params()
    jstore = JaxStore(str(tmp_path), keep=3)
    jstore.publish(1, pj)

    def publish(scale):
        jstore.publish(2, jax.tree_util.tree_map(lambda a: a * scale, pj))

    def submit(svc, x, fog):
        svc.submit(x, fog=fog)

    runs = []
    for port in (True, False):
        clock = HandClock()
        kw = dict(buckets=BUCKETS, max_wait_s=MAX_WAIT_S, max_queue=8,
                  weight_dtype=weight_dtype, clock=clock)
        if port:
            like = tae.from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
            svc = ScoringService(
                CheckpointStore(str(tmp_path)), like, device="cpu",
                calibrator=StreamingCalibrator(capacity=4096, n_fog=N_FOG), **kw,
            )
        else:
            svc = JaxService(
                JaxStore(str(tmp_path)), pj,
                calibrator=JaxCalibrator(capacity=4096, n_fog=N_FOG), **kw,
            )
        out = _replay(svc, clock, _script(np.random.default_rng(0)), publish, submit)
        runs.append((svc, out))
        if port:                          # the JAX run publishes step 2 afresh
            jstore = JaxStore(str(tmp_path), keep=3)
            for step in jstore.steps()[1:]:
                (tmp_path / f"step_{step:08d}.npz").unlink()
    (tsvc, tout), (jsvc, jout) = runs
    np.testing.assert_allclose(tout["ingest"], jout["ingest"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tsvc.calibrator.taus().numpy(), np.asarray(jsvc.calibrator.taus()), rtol=1e-5
    )
    assert tout["poll"] is jout["poll"] is True
    assert tsvc.loaded_step == jsvc.loaded_step == 2
    _assert_same_results(tout["results"], jout["results"])
    _assert_same_stats(tsvc.stats, jsvc.stats)
    assert tsvc.stats.dropped == 2 and tsvc.stats.swaps == 1
    assert tsvc.stats.compiles_by_bucket == {128: 1, 1024: 1}
    assert tsvc.stats.partial_flushes >= 3


def test_multi_tenant_matches_jax(tmp_path):
    dirs = {name: tmp_path / name for name in ("basin_a", "basin_b")}
    jstores = {name: JaxStore(str(d), keep=3) for name, d in dirs.items()}
    for i, (name, st) in enumerate(jstores.items()):
        st.publish(1, _params(i))

    def publish(scale):
        jstores["basin_b"].publish(
            2, jax.tree_util.tree_map(lambda a: a * scale, _params(1))
        )

    def submit(svc, x, fog):
        svc.submit("basin_a" if x.size % 2 else "basin_b", x, fog=fog)

    def script(rng):
        ops = [s for s in _script(rng) if s[0] != "ingest"]
        return ops

    runs = []
    for port in (True, False):
        clock = HandClock()
        if port:
            like = tae.init(torch.Generator().manual_seed(0), device="cpu")
            svc = MultiTenantService(like, buckets=BUCKETS, max_wait_s=MAX_WAIT_S,
                                     clock=clock, device="cpu")
            for name, d in dirs.items():
                svc.add_tenant(name, CheckpointStore(str(d)), tau=40.0)
        else:
            svc = JaxMulti(_params(), buckets=BUCKETS, max_wait_s=MAX_WAIT_S, clock=clock)
            for name, d in dirs.items():
                svc.add_tenant(name, JaxStore(str(d)), tau=40.0)
        out = _replay(svc, clock, script(np.random.default_rng(1)), publish, submit)
        runs.append((svc, out))
        if port:
            (dirs["basin_b"] / "step_00000002.npz").unlink()
    (tsvc, tout), (jsvc, jout) = runs
    assert tout["poll"] == jout["poll"] == {"basin_a": False, "basin_b": True}
    _assert_same_results(tout["results"], jout["results"])
    for name in dirs:
        _assert_same_stats(tsvc.tenant(name).stats, jsvc.tenant(name).stats)
    assert tsvc.compiles_by_bucket == jsvc.compiles_by_bucket == {128: 1, 1024: 1}
    ts, js = tsvc.summary(), jsvc.summary()
    for key in ("compiles", "requests", "samples", "steps"):
        assert ts[key] == js[key]


def test_replay_on_virtual_clock_completes(tmp_path):
    """The load harness duck-types over the port's service: every event
    completes and each bucket is prepared once."""
    store = CheckpointStore(str(tmp_path))
    params = tae.init(torch.Generator().manual_seed(0), device="cpu")
    store.publish(1, params)
    clock = VirtualClock()
    svc = ScoringService(store, params, buckets=BUCKETS, max_wait_s=MAX_WAIT_S,
                         tau=40.0, clock=clock, device="cpu")
    tr = mmpp_trace(1, rate_on_hz=400.0, mean_on_s=0.2, mean_off_s=0.3, duration_s=1.5,
                    fleet=32, n_fog=4, rows=16)
    rep = replay(svc, tr, clock, d=32)
    assert rep.completed == tr.n_events and rep.samples == tr.total_rows
    assert set(rep.compiles_by_bucket.values()) == {1}
    assert rep.virtual_s >= float(tr.t[-1])


def test_device_none_means_the_card(tmp_path, monkeypatch):
    """With no CUDA device, the default device raises instead of running
    on the CPU; shared programs pin the device."""
    from repro_torch import device as dev

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dev.default_device()
    store = CheckpointStore(str(tmp_path))
    params = tae.init(torch.Generator().manual_seed(0), device="cpu")
    store.publish(1, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScoringService(store, params, tau=1.0)
    programs = ScorePrograms(device="cpu")
    with pytest.raises(ValueError, match="shared programs run on"):
        ScoringService(store, params, tau=1.0, programs=programs, device="meta")
    with pytest.raises(ValueError, match="weight_dtype"):
        ScorePrograms(weight_dtype="int4", device="cpu")


def test_device_rejects_a_card_that_is_not_hopper(monkeypatch):
    from repro_torch import device as dev

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda i=0: (8, 0))
    with pytest.raises(RuntimeError, match="capability"):
        dev.default_device()

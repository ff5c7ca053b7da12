"""Port parity: the fused score path and int8 quantisation, PyTorch vs JAX.

The same numpy-seeded inputs go through ``repro`` (its jnp oracle and its
Pallas kernel in interpret mode) and through ``repro_torch`` on the CPU
(the plain versions that the CUDA kernels are held against on the card).
Errors agree to ``rtol=1e-5, atol=1e-5`` (the tolerance of the JAX
package's own kernel-vs-oracle tests); flags agree exactly, except on rows
whose error lies within ``1e-5 * max(1, |tau|)`` of tau, where the two
summation orders may round to opposite sides.
"""
import contextlib
import importlib
import types

import jax
import numpy as np
import pytest
import torch
from torch_parity import one_intra_op_thread  # noqa: F401

from repro.kernels import ops as jops
from repro.models import autoencoder as jae
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import autoencoder as tae

# The serving packages re-export a function named ``score`` that shadows
# the submodule, so the modules are fetched by name.
jscore = importlib.import_module("repro.serving.score")
tscore = importlib.import_module("repro_torch.serving.score")

SHAPES = [
    (37, 32, (16, 8, 16)),     # rows below one TPU tile
    (256, 32, (16, 8, 16)),    # whole TPU tiles
    (130, 130, (64, 8, 64)),   # feature dim above the TPU's 128 lanes
]


def _jax_params(d, hidden, seed=1):
    return jax.tree_util.tree_map(
        lambda a: np.array(a), jae.init(jax.random.key(seed), d, hidden)
    )


def _inputs(r, d, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((r, d)).astype(np.float32)


def _per_row_tau(err, seed):
    """Per-row thresholds spread over the error range."""
    rng = np.random.default_rng(seed + 1)
    lo, hi = np.nanmin(err), np.nanmax(err)
    return rng.uniform(lo, hi, err.shape).astype(np.float32)


def assert_flags_match(flag, flag_ref, err_ref, tau):
    tau = np.broadcast_to(np.asarray(tau, np.float32), np.shape(err_ref))
    with np.errstate(invalid="ignore"):
        near = np.abs(err_ref - tau) <= 1e-5 * np.maximum(1.0, np.abs(tau))
    np.testing.assert_array_equal(np.asarray(flag)[~near], np.asarray(flag_ref)[~near])


def _jax_both(fn, x, params, tau):
    """(oracle, Pallas-interpret) results of a JAX ``kernels.ops`` fn."""
    return (
        fn(x, params, tau, use_pallas=False),
        fn(x, params, tau, use_pallas=True, interpret=True),
    )


@pytest.mark.parametrize("r,d,hidden", SHAPES)
def test_fused_score_matches_jax_oracle_and_pallas(r, d, hidden):
    params = _jax_params(d, hidden)
    x = _inputs(r, d, r)
    err0, _ = jops.fused_score(x, params, np.inf, use_pallas=False)
    tau = _per_row_tau(np.asarray(err0), r)
    tp = tae.from_numpy(params, "cpu")
    err, flag = tops.fused_score(torch.from_numpy(x), tp, torch.from_numpy(tau))
    assert err.dtype == torch.float32 and flag.dtype == torch.bool
    for err_j, flag_j in _jax_both(jops.fused_score, x, params, tau):
        np.testing.assert_allclose(err.numpy(), np.asarray(err_j), rtol=1e-5, atol=1e-5)
        assert_flags_match(flag.numpy(), np.asarray(flag_j), np.asarray(err_j), tau)


@pytest.mark.parametrize("r,d,hidden", SHAPES)
def test_fused_score_q8_matches_jax_oracle_and_pallas(r, d, hidden):
    params = _jax_params(d, hidden, seed=2)
    qj = jax.tree_util.tree_map(np.asarray, jscore.quantize_params(params))
    x = _inputs(r, d, r + 7)
    err0, _ = jops.fused_score_q8(x, qj, np.inf, use_pallas=False)
    tau = _per_row_tau(np.asarray(err0), r)
    qt = tae.from_numpy(qj, "cpu")
    err, flag = tops.fused_score_q8(torch.from_numpy(x), qt, torch.from_numpy(tau))
    for err_j, flag_j in _jax_both(jops.fused_score_q8, x, qj, tau):
        np.testing.assert_allclose(err.numpy(), np.asarray(err_j), rtol=1e-5, atol=1e-5)
        assert_flags_match(flag.numpy(), np.asarray(flag_j), np.asarray(err_j), tau)


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("shape", [(4, 48, 32), (3, 40, 32)])
def test_fleet_batches_match_jax_serving_score(shape, q8):
    """(fleet, window, d) batches through ``serving.score`` / ``score_q8``
    keep their leading shape and match the JAX front-end."""
    params = _jax_params(32, (16, 8, 16), seed=3)
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    tau = rng.uniform(10.0, 40.0, shape[:-1]).astype(np.float32)
    if q8:
        pj = jax.tree_util.tree_map(np.asarray, jscore.quantize_params(params))
        fj, ft = jscore.score_q8, tscore.score_q8
    else:
        pj, fj, ft = params, jscore.score, tscore.score
    res = ft(tae.from_numpy(pj, "cpu"), x, tau)
    assert res.error.shape == shape[:-1] and res.flag.shape == shape[:-1]
    for use_pallas in (False, True):
        rj = fj(pj, x, tau, use_pallas=use_pallas, interpret=True)
        np.testing.assert_allclose(
            res.error.numpy(), np.asarray(rj.error), rtol=1e-5, atol=1e-5
        )
        assert_flags_match(res.flag.numpy(), np.asarray(rj.flag), np.asarray(rj.error), tau)


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("tau,expect", [(np.inf, False), (-np.inf, True), (-1.0, True)])
def test_degenerate_thresholds(tau, expect, q8):
    """tau=+inf flags nothing, tau=-inf (or any negative tau) everything:
    errors are squared norms >= 0.  JAX agrees on both of its paths."""
    params = _jax_params(32, (16, 8, 16))
    pj = jax.tree_util.tree_map(np.asarray, jscore.quantize_params(params)) if q8 else params
    x = _inputs(120, 32, 5)
    fn_t = tops.fused_score_q8 if q8 else tops.fused_score
    fn_j = jops.fused_score_q8 if q8 else jops.fused_score
    _, flag = fn_t(torch.from_numpy(x), tae.from_numpy(pj, "cpu"), tau)
    assert bool(torch.all(flag == expect))
    for _, flag_j in _jax_both(fn_j, x, pj, tau):
        np.testing.assert_array_equal(flag.numpy(), np.asarray(flag_j))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("q8", [False, True])
def test_nan_rows_flagged(q8, fused):
    """NaN/inf telemetry gives a non-finite error; the serving policy flags
    it anomalous (``NaN > tau`` alone would pass it), as in JAX."""
    params = _jax_params(32, (16, 8, 16))
    x = _inputs(5, 32, 33)
    x[1] = np.nan
    x[3, 0] = np.inf
    if q8:
        pj = jax.tree_util.tree_map(np.asarray, jscore.quantize_params(params))
        res = tscore.score_q8(tae.from_numpy(pj, "cpu"), x, np.inf, fused=fused)
        rj = jscore.score_q8(pj, x, np.inf, use_pallas=False, fused=fused)
    else:
        res = tscore.score(tae.from_numpy(params, "cpu"), x, np.inf, fused=fused)
        rj = jscore.score(params, x, np.inf, use_pallas=False, fused=fused)
    flag = res.flag.numpy()
    assert flag[1] and flag[3]
    np.testing.assert_array_equal(flag[[0, 2, 4]], False)
    np.testing.assert_array_equal(flag, np.asarray(rj.flag))
    np.testing.assert_array_equal(np.isnan(res.error.numpy()), np.isnan(np.asarray(rj.error)))


@pytest.mark.parametrize("q8", [False, True])
def test_unfused_baseline_matches_fused(q8):
    params = tae.from_numpy(_jax_params(32, (16, 8, 16), seed=4), "cpu")
    if q8:
        params = tscore.quantize_params(params)
    fn = tscore.score_q8 if q8 else tscore.score
    x = _inputs(300, 32, 8)
    a = fn(params, x, 25.0, fused=True)
    b = fn(params, x, 25.0, fused=False)
    np.testing.assert_allclose(a.error.numpy(), b.error.numpy(), rtol=1e-5, atol=1e-5)
    assert_flags_match(a.flag.numpy(), b.flag.numpy(), b.error.numpy(), 25.0)


@pytest.mark.parametrize("d,hidden", [(32, (16, 8, 16)), (130, (64, 8, 64)), (8, (3,))])
def test_quantize_params_matches_jax(d, hidden):
    """qw bit-equal (round half to even, clip ±127), sw to 1e-7; all-zero
    weight columns stay zero with a zero scale."""
    params = _jax_params(d, hidden, seed=d)
    params[0]["w"][:, 1] = 0.0                       # an all-zero column
    qj = jscore.quantize_params(params)
    qt = tscore.quantize_params(tae.from_numpy(params, "cpu"))
    for lj, lt in zip(qj, qt):
        assert lt["qw"].dtype == torch.int8 and tuple(lt["sw"].shape) == (1, lj["qw"].shape[1])
        np.testing.assert_array_equal(lt["qw"].numpy(), np.asarray(lj["qw"]))
        np.testing.assert_allclose(lt["sw"].numpy(), np.asarray(lj["sw"]), rtol=0, atol=1e-7)
        np.testing.assert_array_equal(lt["b"].numpy(), np.asarray(lj["b"]))
    assert not qt[0]["qw"][:, 1].any() and float(qt[0]["sw"][0, 1]) == 0.0
    deq_j = jscore.dequantize_params(qj)
    deq_t = tscore.dequantize_params(qt)
    for lj, lt in zip(deq_j, deq_t):
        np.testing.assert_allclose(lt["w"].numpy(), np.asarray(lj["w"]), rtol=1e-6, atol=1e-7)


def test_quantize_rounds_half_to_even():
    """A weight exactly k + 0.5 steps of its column scale rounds to the
    even code, as ``jnp.round`` does."""
    w = np.asarray([[127.0, 127.0], [2.5, 3.5], [-2.5, 0.5]], np.float32)
    qt = tscore.quantize_params([{"w": torch.from_numpy(w), "b": torch.zeros(2)}])
    qj = jscore.quantize_params([{"w": w, "b": np.zeros(2, np.float32)}])
    np.testing.assert_array_equal(qt[0]["qw"].numpy(), np.asarray(qj[0]["qw"]))
    np.testing.assert_array_equal(qt[0]["qw"].numpy()[:, 0], [127, 2, -2])


def test_score_fleet_per_fog_thresholds():
    params = tae.from_numpy(_jax_params(32, (16, 8, 16)), "cpu")
    x = _inputs(64, 32, 11).reshape(4, 16, 32)
    fog_tau = torch.tensor([np.inf, -1.0])   # fog 0 never, fog 1 always
    res = tscore.score_fleet(params, x, fog_tau=fog_tau, fog_id=torch.tensor([0, 1, 0, 1]))
    np.testing.assert_array_equal(res.flag.numpy().any(axis=1), [False, True, False, True])
    with pytest.raises(ValueError):
        tscore.score_fleet(params, x, tau=1.0, fog_tau=fog_tau, fog_id=[0, 1, 0, 1])


def test_ref_takes_real_widths_without_padding():
    """The plain version works on the unpadded (R, d) rows directly and
    agrees with the JAX oracle at a ragged width."""
    params = _jax_params(19, (7, 5))
    x = _inputs(11, 19, 2)
    tau = np.full((11,), 10.0, np.float32)
    err_j, flag_j = jops.fused_score(x, params, tau, use_pallas=False)
    tp = tae.from_numpy(params, "cpu")
    err, flag = tref.fused_score_ref(
        torch.from_numpy(x), tuple(p["w"] for p in tp), tuple(p["b"] for p in tp),
        torch.from_numpy(tau),
    )
    np.testing.assert_allclose(err.numpy(), np.asarray(err_j), rtol=1e-5, atol=1e-5)
    assert_flags_match(flag.numpy(), np.asarray(flag_j), np.asarray(err_j), tau)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The launch wrappers take CUDA tensors only; the CPU route is
    ``kernels/ops``' and never reaches them."""
    from repro_torch.kernels import fused_score as fs

    tp = tae.from_numpy(_jax_params(32, (16, 8, 16)), "cpu")
    x = torch.zeros((4, 32))
    with pytest.raises(ValueError, match="CUDA"):
        fs.score_rows(x, torch.zeros(4), tuple(p["w"] for p in tp), tuple(p["b"] for p in tp))
    before = dict(fs.LAUNCHES)
    tops.fused_score(x, tp, 1.0)
    assert fs.LAUNCHES == before


PAPER = (32, 16, 8, 16, 32)
WIDE_DIMS = (130, 64, 8, 64, 130)


WEIGHTS = ["f32", "int8"]


def _launched_plan(monkeypatch, dims, rows, weights):
    """The plan the wrapper of ``weights``' kernel launches with on an H100
    SXM's 132 SMs: the wrapper runs on CPU tensors against a recording
    stand-in for the library."""
    from repro_torch.kernels import fused_score as fs

    plans = []

    def record(*args):   # ..., paper, warps, blocks, strides, strip, w_floats, smem, stream
        plans.append(fs.Plan(bool(args[-9]), *args[-8:-1]))
        return 0

    lib = types.SimpleNamespace(fused_score_f32=record, fused_score_q8=record)
    monkeypatch.setattr(fs, "_library", lambda: lib)
    monkeypatch.setattr(fs, "_sm_count", lambda device: 132)
    monkeypatch.setattr(fs._launch, "require_cuda", lambda t, what: t.device)
    monkeypatch.setattr(fs._launch, "stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    g = torch.Generator().manual_seed(rows)
    x = torch.randn((rows, dims[0]), generator=g)
    tau = torch.zeros((rows,))
    ws = tuple(torch.randn((a, b), generator=g) for a, b in zip(dims[:-1], dims[1:]))
    bs = tuple(torch.zeros((b,)) for b in dims[1:])
    if weights == "f32":
        fs.score_rows(x, tau, ws, bs)
    else:
        fs.score_rows_q8(x, tau, tuple(w.to(torch.int8) for w in ws),
                         tuple(torch.ones((1, b)) for b in dims[1:]), bs)
    assert len(plans) == 1
    return plans[0]


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize(
    "dims,rows,want",
    [(PAPER, 128, (True, 1, 32)),      # serve bucket: a warp per 4 rows, one per block
     (PAPER, 1024, (True, 1, 256)),    # the large bucket over every SM
     (PAPER, 65536, (True, 8, 264)),   # 16 resident warps per SM walk the groups
     (PAPER, 1, (True, 1, 1)),
     (WIDE_DIMS, 1024, (False, 8, 32)),
     ((32, 32), 7, (False, 8, 1))],
)
def test_f32_plan_at_the_main_paths_shapes(monkeypatch, dims, rows, want, weights):
    """The launch on an H100 SXM's 132 SMs, for f32 and int8 weights alike:
    the instance, warps per block and blocks; enough warps for every 4-row
    group up to 16 per SM, the paper AE's blocks as narrow as keeps one
    per SM."""
    from repro_torch.kernels import fused_score as fs

    p = _launched_plan(monkeypatch, dims, rows, weights)
    assert p == fs.plan(dims, rows, 132)
    assert (p.paper, p.warps, p.blocks) == want
    groups = -(-rows // fs.ROWS_PER_WARP)
    assert min(groups, 132 * fs.RESIDENT_WARPS) <= p.warps * p.blocks
    assert p.warps * (p.blocks - 1) < min(groups, 132 * fs.RESIDENT_WARPS)
    assert p.smem <= fs.SMEM_LIMIT


@pytest.mark.parametrize("weights", WEIGHTS)
def test_f32_plan_depends_on_widths_not_rows(monkeypatch, weights):
    """The instance and the strip layout are the same at every row count,
    for f32 and int8 weights alike, so a row scores alike in every
    bucket."""
    from repro_torch.kernels import fused_score as fs

    for dims in (PAPER, WIDE_DIMS, (24, 20, 16, 12, 8, 12, 16, 20, 24)):
        plans = [_launched_plan(monkeypatch, dims, r, weights) for r in (1, 31, 128, 1024, 65537)]
        assert len({(p.paper, p.x_stride, p.h_stride, p.strip, p.w_floats) for p in plans}) == 1
        if dims != PAPER:
            p = plans[0]
            assert p.x_stride % 4 == 0 and p.x_stride >= dims[0]
            assert p.h_stride % 4 == 0 and p.h_stride >= max(dims[1:-1])
            assert p.smem == 4 * (p.w_floats + p.warps * p.strip)


@pytest.mark.parametrize("weights", WEIGHTS)
def test_f32_plan_refuses_widths_beyond_shared_memory(monkeypatch, weights):
    with pytest.raises(ValueError, match="shared memory"):
        _launched_plan(monkeypatch, (512, 256, 512), 1024, weights)

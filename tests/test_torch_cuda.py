"""The CUDA kernels against their plain versions, on the Hopper card.

Every test here takes the ``cuda`` fixture, which skips when there is no
sm_90 card; whether there is one is decided inside the fixture, never at
import, so every pytest worker collects the same tests.  On the card:
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest``: ``tests/conftest.py`` imports JAX, which the card's
machine does not have).

Tolerance: score errors to ``rtol=1e-5, atol=1e-5`` (the kernel sums in
another order than PyTorch's matmul); flags exactly, except on rows within
``1e-5 * max(1, |tau|)`` of tau.  The whole service on the card and on
the CPU: each held to an f64 evaluation within the derived forward-error
bound of f32 (see ``_score_bound``).  Training kernels: local-train deltas
to ``rtol=1e-4, atol=1e-6`` and losses to ``rtol=1e-5``; compress-aggregate
survivor sets exactly, new_err to ``atol=1e-5`` and fog sums to
``rtol=1e-5, atol=1e-4`` (the reference's kernel-vs-oracle tolerances).
Robust aggregation to ``rtol=1e-5, atol=1e-6`` (the selection is exact
with integer weights; only num / den round apart); the wire's slots, codes,
scales and new_err exactly (the same IEEE operations as the plain
version), its fog sums to ``rtol=1e-5, atol=1e-4``.  The per-client compressor kernels
(``compress_q8``, ``topk_ef``, ``quant8``) bitwise: codes, scales, sparse
values and new_err, the tie and all-zero rows included (the kernels and
their plain versions make the same IEEE operations, none contracted).
``swa_decode``: f32 to ``atol=2e-5, rtol=1e-4``, bf16 equal or one ulp
apart; over its split edges (splits holding no position, a window
shorter than a tile, len 1 and S + window, g = 1 / 10 / 16 / 36) and
bitwise equal across calls.  ``local_train_f32`` also at batches 1, 7
and 33 and at widths without a compile-time instance.  ``fused_score_f32``
and ``fused_score_q8`` also at rows 1 to 65,537 at four depths, and a
row's err bitwise equal in any batch; ``fused_score_q8``'s err bitwise
``fused_score_f32``'s on the dequantised weights.  ``local_train_f32`` with
one start vector per trial (theta (B, d)) bitwise equal to B launches; an
``Engine`` cell launching each kernel as often as one trial does; an
``hfl-async`` trial on the card against its CPU twin event by event, and
its ``Engine`` cells' launches.  ``wire_agg`` bitwise
equal to ``ref.wire_fold_ref``, the client-order fold; ``fused_agg``'s fog
sums bitwise equal to ``ref.dense_fold_ref``, its thresholds and new_err
to the plain version's; the member lists ``robust_agg`` builds on the
card equal to ``robust_agg.member_lists`` element for element.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.core import aggregation as agg
from repro_torch.core import compression as comp
from repro_torch.core.drift import DriftConfig
from repro_torch.core.faults import FaultConfig
from repro_torch.data.pipeline import multi_epoch_indices
from repro_torch.data.synthetic import SyntheticConfig, generate, normalize
from repro_torch.engine import Engine
from repro_torch.kernels import fused_agg as fa
from repro_torch.kernels import fused_score as fs
from repro_torch.kernels import local_train as lt
from repro_torch.kernels import ops, ref
from repro_torch.kernels import quant8 as q8
from repro_torch.kernels import robust_agg as ra
from repro_torch.kernels import topk_ef as tk
from repro_torch.launch import experiment as exp
from repro_torch.models import autoencoder as ae
from repro_torch.serving import ScoringService, quantize_params

pytestmark = pytest.mark.cuda

WIDTHS = [(32, (16, 8, 16)), (130, (64, 8, 64))]
ROWS = [1, 127, 128, 1024, 25600, 65536]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("cuda: no CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("cuda: the kernels need an sm_90 (Hopper) card")
    return torch.device("cuda:0")


def _case(d, hidden, rows, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = ae.init(g, d, hidden, device=device)
    x = torch.randn((rows, d), generator=g).to(device)
    if rows > 2:
        x[rows // 2] = float("nan")
    tau = (torch.rand((rows,), generator=g) * 2.0 * d).to(device)
    return params, x, tau


def _assert_match(err, flag, err_ref, flag_ref, tau):
    err, flag, err_ref, flag_ref, tau = (
        t.cpu().numpy() for t in (err, flag, err_ref, flag_ref, tau)
    )
    np.testing.assert_allclose(err, err_ref, rtol=1e-5, atol=1e-5, equal_nan=True)
    with np.errstate(invalid="ignore"):
        near = np.abs(err_ref - tau) <= 1e-5 * np.maximum(1.0, np.abs(tau))
    np.testing.assert_array_equal(flag[~near], flag_ref[~near])


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("d,hidden", WIDTHS)
def test_f32_kernel_matches_plain(cuda, d, hidden, rows):
    params, x, tau = _case(d, hidden, rows, cuda)
    ws = tuple(p["w"] for p in params)
    bs = tuple(p["b"] for p in params)
    before = fs.LAUNCHES["fused_score_f32"]
    err, flag = fs.score_rows(x, tau, ws, bs)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["fused_score_f32"] == before + 1
    _assert_match(err, flag, *ref.fused_score_ref(x, ws, bs, tau), tau)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("d,hidden", WIDTHS)
def test_q8_kernel_matches_plain(cuda, d, hidden, rows):
    params, x, tau = _case(d, hidden, rows, cuda, seed=1)
    q = quantize_params(params)
    qws, sws, bs = (tuple(p[k] for p in q) for k in ("qw", "sw", "b"))
    before = fs.LAUNCHES["fused_score_q8"]
    err, flag = fs.score_rows_q8(x, tau, qws, sws, bs)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["fused_score_q8"] == before + 1
    _assert_match(err, flag, *ref.fused_score_q8_ref(x, qws, sws, bs, tau), tau)


def test_ops_route_cuda_tensors_to_the_kernel(cuda):
    params, x, tau = _case(32, (16, 8, 16), 300, cuda)
    before = dict(fs.LAUNCHES)
    ops.fused_score(x, params, tau)
    ops.fused_score_q8(x, quantize_params(params), tau)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["fused_score_f32"] == before["fused_score_f32"] + 1
    assert fs.LAUNCHES["fused_score_q8"] == before["fused_score_q8"] + 1


def test_wrapper_checks_inputs(cuda):
    params, x, tau = _case(32, (16, 8, 16), 64, cuda)
    ws = tuple(p["w"] for p in params)
    bs = tuple(p["b"] for p in params)
    with pytest.raises(TypeError):
        fs.score_rows(x.double(), tau, ws, bs)
    with pytest.raises(ValueError, match="contiguous"):
        fs.score_rows(x.t().contiguous().t(), tau, ws, bs)
    with pytest.raises(ValueError, match="shape"):
        fs.score_rows(x, tau[:10], ws, bs)
    with pytest.raises(ValueError, match="on cpu"):
        fs.score_rows(x, tau, (ws[0].cpu(),) + ws[1:], bs)
    big = ae.init(torch.Generator().manual_seed(0), 512, (256,), device=cuda)
    x_big, tau_big = torch.zeros((8, 512), device=cuda), torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        fs.score_rows(x_big, tau_big, tuple(p["w"] for p in big), tuple(p["b"] for p in big))
    q = quantize_params(big)
    with pytest.raises(ValueError, match="shared memory"):
        fs.score_rows_q8(x_big, tau_big, *(tuple(p[k] for p in q) for k in ("qw", "sw", "b")))


U = 2.0 ** -24       # unit roundoff of f32


def _gamma(n: int) -> float:
    return n * U / (1.0 - n * U)


def _score_bound(x, ws, bs):
    """(err, bound): the rows' reconstruction errors in f64 and a bound on
    how far ANY f32 evaluation of the same f32 weights can land from them.

    Derivation (Higham, Accuracy and Stability of Numerical Algorithms,
    Thm 3.1 and Sec. 3.1): an f32 dot product of n terms plus a bias, in
    any summation order and with or without FMA, is within
    gamma_{n+1} (|h| . |W| + |b|) of the exact value, gamma_n = n u / (1 -
    n u), u = 2^-24.  So with e the bound on the layer input's error,
    |dz| <= |W|^T e + gamma_{n+1} (|W|^T (|h| + e) + |b|).  tanh is
    1-Lipschitz and an f32 tanh is within 4 ulp (8 u relative; CUDA's
    tanhf is within 2, PyTorch's CPU tanh within 1), so a hidden layer's
    output error is dz + 8 u (|h| + dz).  The residual r = x - recon picks
    up the output error e and one rounding: dr = e + u (|r| + e).  Each
    square rounds once and the d squares sum in any order:
    |err' - err| <= sum(2 |r| dr + dr^2) + gamma_{d+1} sum((|r| + dr)^2).
    Per layer that is (width + 1) u relative to |W|^T |h|, which exceeds
    |W^T h| by the cancellation in each row; for the random paper AE of
    the test (four layers of at most 32 terms) the bound comes to ~2.5e-4
    of err, and the CPU service's own error to under 0.1% of the bound.
    """
    x = x.astype(np.float64)
    h, e = x, np.zeros_like(x)
    for i, (w, b) in enumerate(zip(ws, bs)):
        w, b = w.astype(np.float64), b.astype(np.float64)
        aw = np.abs(w)
        z = h @ w + b
        dz = e @ aw + _gamma(w.shape[0] + 1) * ((np.abs(h) + e) @ aw + np.abs(b))
        if i < len(ws) - 1:
            h = np.tanh(z)
            e = dz + 8 * U * (np.abs(h) + dz)
        else:
            h, e = z, dz
    r = x - h
    dr = e + U * (np.abs(r) + e)
    err = np.sum(r * r, axis=-1)
    bound = (np.sum(2 * np.abs(r) * dr + dr * dr, axis=-1)
             + _gamma(x.shape[-1] + 1) * np.sum((np.abs(r) + dr) ** 2, axis=-1))
    return err, bound


@pytest.mark.parametrize("weight_dtype", ["f32", "int8"])
def test_service_on_the_card_matches_cpu_service(cuda, tmp_path, weight_dtype):
    """The card's and the CPU's service, each held to an f64 evaluation of
    the same f32 weights within ``_score_bound``; flags exactly outside a
    band of that width around tau.  (Two correct f32 summation orders can
    differ by more than 1e-5 relative: a fixed rtol between them is not a
    property of either.)"""
    store = CheckpointStore(str(tmp_path))
    params = ae.init(torch.Generator().manual_seed(2), device="cpu")
    store.publish(1, params)
    rng = np.random.default_rng(0)
    reqs = [rng.standard_normal((n, 32)).astype(np.float32) for n in (10, 200, 1500, 64)]
    if weight_dtype == "int8":     # the kernel dequantises to the same f32 weights
        q = quantize_params(params)
        ws = [(p["qw"].to(torch.float32) * p["sw"].reshape(1, -1)).numpy() for p in q]
    else:
        ws = [p["w"].numpy() for p in params]
    bs = [p["b"].numpy() for p in params]
    tau = 30.0
    for device in (None, "cpu"):
        svc = ScoringService(store, params, buckets=(128, 1024), tau=tau,
                             weight_dtype=weight_dtype, device=device)
        rids = [svc.submit(r, fog=None) for r in reqs]
        res = svc.drain()
        assert svc.device.type == ("cuda" if device is None else "cpu")
        for rid, rows in zip(rids, reqs):
            err64, bound = _score_bound(rows, ws, bs)
            assert np.all(np.abs(res[rid].error - err64) <= bound), device
            far = np.abs(err64 - tau) > bound
            np.testing.assert_array_equal(res[rid].flag[far], (err64 > tau)[far])


SCORE_AES = {                       # name -> (d, hidden): the instances and depths
    "paper": (32, (16, 8, 16)),
    "wide": (130, (64, 8, 64)),
    "one layer": (32, ()),
    "eight layers": (24, (20, 16, 12, 8, 12, 16, 20)),
}
SCORE_ROWS = [1, 31, 32, 33, 127, 128, 1024, 65537]


def _score_case(name, rows, device, seed):
    """``_case`` with biases drawn too (``ae.init`` zeroes them)."""
    d, hidden = SCORE_AES[name]
    params, x, tau = _case(d, hidden, rows, device, seed)
    g = torch.Generator().manual_seed(seed + 1)
    for layer in params:
        layer["b"] = (0.1 * torch.randn(layer["b"].shape, generator=g)).to(device)
    return tuple(p["w"] for p in params), tuple(p["b"] for p in params), x, tau


@pytest.mark.parametrize("rows", SCORE_ROWS)
@pytest.mark.parametrize("name", list(SCORE_AES))
def test_f32_kernel_rows_and_depths(cuda, name, rows):
    """Ragged groups of 4 rows, one row short of and past a warp's 32
    lanes, the compile-time instance and the generic one at 1, 4 and 8
    layers."""
    ws, bs, x, tau = _score_case(name, rows, cuda, seed=rows)
    before = fs.LAUNCHES["fused_score_f32"]
    err, flag = fs.score_rows(x, tau, ws, bs)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["fused_score_f32"] == before + 1
    _assert_match(err, flag, *ref.fused_score_ref(x, ws, bs, tau), tau)


@pytest.mark.parametrize("name", ["paper", "wide"])
def test_f32_kernel_err_is_bitwise_the_same_in_any_batch(cuda, name):
    """A row's err does not depend on the batch, the group or the lanes it
    lands in: rows 301..428 of a 1,024-row batch scored again as a 128-row
    batch (another offset within their groups), and the batch twice."""
    ws, bs, x, tau = _score_case(name, 1024, cuda, seed=5)
    err, flag = fs.score_rows(x, tau, ws, bs)
    again, flag_again = fs.score_rows(x, tau, ws, bs)
    part, flag_part = fs.score_rows(x[301:429].contiguous(), tau[301:429].contiguous(), ws, bs)
    torch.cuda.synchronize()
    assert torch.equal(err.isnan(), again.isnan()) and torch.equal(flag, flag_again)
    fin = ~err.isnan()
    assert torch.equal(err[fin], again[fin])
    assert torch.equal(err[301:429][fin[301:429]], part[fin[301:429]])
    assert torch.equal(flag[301:429], flag_part)


def _q8_score_case(name, rows, device, seed):
    """``_score_case`` with the weights quantised: (qws, sws, bs, the
    dequantised f32 weights ``q.to(f32) * s``, x, tau)."""
    ws, bs, x, tau = _score_case(name, rows, device, seed)
    q = quantize_params([{"w": w, "b": b} for w, b in zip(ws, bs)])
    qws, sws = (tuple(p[k] for p in q) for k in ("qw", "sw"))
    deq = tuple(qw.to(torch.float32) * sw.reshape(1, -1) for qw, sw in zip(qws, sws))
    return qws, sws, bs, deq, x, tau


@pytest.mark.parametrize("rows", SCORE_ROWS)
@pytest.mark.parametrize("name", list(SCORE_AES))
def test_q8_kernel_rows_and_depths(cuda, name, rows):
    """``test_f32_kernel_rows_and_depths`` for int8 weights: against the
    plain version, and err bitwise the f32 kernel's on the dequantised
    weights."""
    qws, sws, bs, deq, x, tau = _q8_score_case(name, rows, cuda, seed=rows + 1)
    before = fs.LAUNCHES["fused_score_q8"]
    err, flag = fs.score_rows_q8(x, tau, qws, sws, bs)
    err_f32, flag_f32 = fs.score_rows(x, tau, deq, bs)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["fused_score_q8"] == before + 1
    _assert_match(err, flag, *ref.fused_score_q8_ref(x, qws, sws, bs, tau), tau)
    assert torch.equal(err.isnan(), err_f32.isnan()) and torch.equal(flag, flag_f32)
    assert torch.equal(err[~err.isnan()], err_f32[~err.isnan()])


@pytest.mark.parametrize("name", ["paper", "wide"])
def test_q8_kernel_is_bitwise_the_f32_kernel_on_dequantised_weights(cuda, name):
    """At the paper AE and at d = 130, over the serve buckets and a large
    batch: err and flags of ``fused_score_q8`` equal ``fused_score_f32``'s
    on ``q.to(f32) * s``, bit for bit."""
    for rows in (128, 1024, 65536):
        qws, sws, bs, deq, x, tau = _q8_score_case(name, rows, cuda, seed=rows + 2)
        err, flag = fs.score_rows_q8(x, tau, qws, sws, bs)
        err_f32, flag_f32 = fs.score_rows(x, tau, deq, bs)
        torch.cuda.synchronize()
        fin = ~err_f32.isnan()
        assert torch.equal(err.isnan(), ~fin) and torch.equal(flag, flag_f32), rows
        assert torch.equal(err[fin], err_f32[fin]), rows


@pytest.mark.parametrize("name", ["paper", "wide"])
def test_q8_kernel_err_is_bitwise_the_same_in_any_batch(cuda, name):
    """A row's err in a 65,537-row batch equals its err in batches of 1,
    128 and 1,024 rows taken at other offsets (other groups and lanes)."""
    qws, sws, bs, _, x, tau = _q8_score_case(name, 65537, cuda, seed=9)
    err, flag = fs.score_rows_q8(x, tau, qws, sws, bs)
    fin = ~err.isnan()
    for lo, rows in ((7, 1), (301, 128), (1030, 1024)):
        part, flag_part = fs.score_rows_q8(x[lo:lo + rows].contiguous(),
                                           tau[lo:lo + rows].contiguous(), qws, sws, bs)
        torch.cuda.synchronize()
        keep = fin[lo:lo + rows]
        assert torch.equal(part.isnan(), ~keep) and torch.equal(flag_part, flag[lo:lo + rows])
        assert torch.equal(part[keep], err[lo:lo + rows][keep]), rows


def _train_case(n, window, d, hidden, device, seed=0, bs=32, epochs=5):
    g = torch.Generator().manual_seed(seed)
    params = ae.init(g, d, hidden, device=device)
    x = torch.randn((n, window, d), generator=g).to(device)
    idx = multi_epoch_indices(g, n, window, bs, epochs).to(device)
    return params, x, idx


@pytest.mark.parametrize("mu", [0.0, 0.01])
@pytest.mark.parametrize("n,window", [(1, 48), (13, 256), (200, 256)])
@pytest.mark.parametrize("d,hidden", WIDTHS)
def test_local_train_kernel_matches_plain(cuda, d, hidden, n, window, mu):
    params, x, idx = _train_case(n, window, d, hidden, cuda, seed=n)
    ws = tuple(p["w"] for p in params)
    bs = tuple(p["b"] for p in params)
    before = lt.LAUNCHES["local_train_f32"]
    deltas, loss = lt.train_clients(x, idx, ae.ravel(params), (d, *hidden, d), 0.01, mu)
    torch.cuda.synchronize()
    assert lt.LAUNCHES["local_train_f32"] == before + 1
    d_ref, l_ref = ref.local_train_ref(x, idx, ws, bs, 0.01, mu)
    np.testing.assert_allclose(deltas.cpu().numpy(), d_ref.cpu().numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(loss.cpu().numpy(), l_ref.cpu().numpy(), rtol=1e-5)


@pytest.mark.parametrize("mu", [0.0, 0.01])
@pytest.mark.parametrize("bs,window,epochs", [(1, 48, 1), (7, 100, 2), (33, 100, 2)])
@pytest.mark.parametrize("d,hidden", WIDTHS)
def test_local_train_kernel_takes_any_batch(cuda, d, hidden, bs, window, epochs, mu):
    """Batches below, off and above the 8 warps' rows; the paper AE's
    compile-time instance and the run-time-width one (d = 130).  Batch 1
    runs 48 steps: 200 single-row steps at d = 130 are ill-conditioned
    (the next test)."""
    params, x, idx = _train_case(13, window, d, hidden, cuda, seed=bs, bs=bs, epochs=epochs)
    deltas, loss = lt.train_clients(x, idx, ae.ravel(params), (d, *hidden, d), 0.01, mu)
    d_ref, l_ref = ref.local_train_ref(x, idx, tuple(p["w"] for p in params),
                                       tuple(p["b"] for p in params), 0.01, mu)
    np.testing.assert_allclose(deltas.cpu().numpy(), d_ref.cpu().numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(loss.cpu().numpy(), l_ref.cpu().numpy(), rtol=1e-5)


def test_local_train_single_row_steps_are_ill_conditioned_at_d_130(cuda):
    """200 single-row steps at d = 130: the plain version on the CPU and on
    the card part beyond rtol=1e-4 / atol=1e-6 (so no f32 implementation
    can be held to them there); the kernel stays within twice that spread
    of the card's plain version."""
    params, x, idx = _train_case(13, 100, 130, (64, 8, 64), cuda, seed=1, bs=1, epochs=2)
    ws, bs = tuple(p["w"] for p in params), tuple(p["b"] for p in params)
    deltas, _ = lt.train_clients(x, idx, ae.ravel(params), (130, 64, 8, 64, 130), 0.01, 0.0)
    d_card, _ = ref.local_train_ref(x, idx, ws, bs, 0.01, 0.0)
    d_cpu, _ = ref.local_train_ref(x.cpu(), idx.cpu(), tuple(w.cpu() for w in ws),
                                   tuple(b.cpu() for b in bs), 0.01, 0.0)
    d_card, deltas = d_card.cpu(), deltas.cpu()
    assert not torch.all(torch.abs(d_cpu - d_card) <= 1e-6 + 1e-4 * torch.abs(d_card))
    spread = float(torch.max(torch.abs(d_cpu - d_card)))
    assert float(torch.max(torch.abs(deltas - d_card))) <= 2 * spread


@pytest.mark.parametrize("d,hidden", [(5, (3,)), (64, (32,)), (32, (16, 8, 16, 8, 16))])
def test_local_train_kernel_takes_other_widths(cuda, d, hidden):
    """Run-time widths that do not divide 32, one layer of 32, a deeper
    AE with the paper's widths (no compile-time instance)."""
    params, x, idx = _train_case(13, 64, d, hidden, cuda, seed=d, bs=32, epochs=2)
    deltas, loss = lt.train_clients(x, idx, ae.ravel(params), (d, *hidden, d), 0.01, 0.01)
    d_ref, l_ref = ref.local_train_ref(x, idx, tuple(p["w"] for p in params),
                                       tuple(p["b"] for p in params), 0.01, 0.01)
    np.testing.assert_allclose(deltas.cpu().numpy(), d_ref.cpu().numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(loss.cpu().numpy(), l_ref.cpu().numpy(), rtol=1e-5)


@pytest.mark.parametrize("mu", [0.0, 0.01])
@pytest.mark.parametrize("d,hidden", WIDTHS)
def test_local_train_kernel_per_trial_start_is_bitwise_b_launches(cuda, d, hidden, mu):
    """theta (B, d): B runs of N / B clients in one launch, run b training
    from theta[b], bitwise what B launches of theta[b] give; the paper
    AE's compile-time instance and the run-time-width one."""
    b_n, n, window = 3, 7, 100
    g = torch.Generator().manual_seed(d)
    thetas = torch.stack([ae.ravel(ae.init(g, d, hidden, device="cpu"))
                          for _ in range(b_n)]).to(cuda)
    x = torch.randn((b_n * n, window, d), generator=g).to(cuda)
    idx = multi_epoch_indices(g, b_n * n, window, 32, 2).to(cuda)
    dims = (d, *hidden, d)
    before = lt.LAUNCHES["local_train_f32"]
    deltas, loss = lt.train_clients(x, idx, thetas, dims, 0.01, mu)
    torch.cuda.synchronize()
    assert lt.LAUNCHES["local_train_f32"] == before + 1
    for b in range(b_n):
        rows = slice(b * n, (b + 1) * n)
        d_b, l_b = lt.train_clients(x[rows], idx[rows], thetas[b], dims, 0.01, mu)
        assert torch.equal(deltas[rows], d_b) and torch.equal(loss[rows], l_b), b
    layers = ae.unravel(thetas, ae.init(g, d, hidden, device="cpu"))
    d_ref, l_ref = ref.local_train_ref(x, idx, tuple(p["w"] for p in layers),
                                       tuple(p["b"] for p in layers), 0.01, mu)
    np.testing.assert_allclose(deltas.cpu().numpy(), d_ref.cpu().numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(loss.cpu().numpy(), l_ref.cpu().numpy(), rtol=1e-5)
    assert torch.equal(ops.local_train(layers, x, idx, 0.01, mu)[0], deltas)
    with pytest.raises(ValueError, match="into trials"):
        lt.train_clients(x[:-1], idx[:-1], thetas, dims, 0.01, mu)


def _agg_case(n, d, n_fog, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    deltas = torch.randn((n, d), generator=g)
    err = 0.1 * torch.randn((n, d), generator=g)
    fog_id = torch.randint(0, n_fog, (n,), generator=g, dtype=torch.int32)
    fog_id[fog_id == 1] = 0                        # fog 1 stays empty
    weights = torch.rand((n,), generator=g)
    weights[::3] = 0.0                             # non-participants
    return tuple(t.to(device) for t in (deltas, err, fog_id, weights))


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("n", [1, 200])
@pytest.mark.parametrize("d", [1352, 8209, 65536])
def test_fused_agg_kernel_matches_plain(cuda, d, n, quantize):
    deltas, err, fog_id, weights = _agg_case(n, d, 20, cuda, seed=d + n)
    k = ops.block_k(0.05)
    before = fa.LAUNCHES["fused_agg"]
    fog_sum, new_err, thr = fa.compress_aggregate_blocks(
        deltas, err, fog_id, weights, 20, k, quantize)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["fused_agg"] == before + 2
    fs_ref, ne_ref, thr_ref = ref.compress_aggregate_ref(
        deltas, err, fog_id, weights, 20, k, quantize)
    absv = ref.pad_blocks(deltas + err).abs()
    np.testing.assert_array_equal((absv > thr[..., None]).cpu().numpy(),
                                  (absv > thr_ref[..., None]).cpu().numpy())
    np.testing.assert_allclose(new_err.cpu().numpy(), ne_ref.cpu().numpy(), atol=1e-5)
    np.testing.assert_allclose(fog_sum.cpu().numpy(), fs_ref.cpu().numpy(), rtol=1e-5, atol=1e-4)
    assert not fog_sum[1].any()


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("n", [1, 200])
@pytest.mark.parametrize("d", [1352, 8209, 65536])
def test_fused_agg_fog_sums_are_the_client_order_fold(cuda, d, n, quantize):
    """The fog sums bitwise equal to ``ref.dense_fold_ref`` (each fog's
    clients added in index order, from 0), an empty fog's row zeros; the
    thresholds and new_err bitwise the plain version's."""
    deltas, err, fog_id, weights = _agg_case(n, d, 20, cuda, seed=d + n)
    k = ops.block_k(0.05)
    fog_sum, new_err, thr = fa.compress_aggregate_blocks(
        deltas, err, fog_id, weights, 20, k, quantize)
    _, ne_ref, thr_ref = ref.compress_aggregate_ref(deltas, err, fog_id, weights, 20, k, quantize)
    assert torch.equal(fog_sum, ref.dense_fold_ref(deltas, err, fog_id, weights, 20, k, quantize))
    assert torch.equal(thr, thr_ref) and torch.equal(new_err, ne_ref)
    assert not fog_sum[1].any()


def test_ops_route_training_tensors_to_the_kernels(cuda):
    params, x, idx = _train_case(12, 48, 32, (16, 8, 16), cuda)
    deltas, err, fog_id, weights = _agg_case(12, 1352, 3, cuda)
    before = (lt.LAUNCHES["local_train_f32"], fa.LAUNCHES["fused_agg"])
    ops.local_train(params, x, idx, 0.01)
    ops.compress_aggregate(deltas, err, fog_id, weights, 3, 0.05)
    torch.cuda.synchronize()
    assert (lt.LAUNCHES["local_train_f32"], fa.LAUNCHES["fused_agg"]) == (
        before[0] + 1, before[1] + 2)


def test_training_wrappers_check_inputs(cuda):
    params, x, idx = _train_case(4, 64, 32, (16, 8, 16), cuda)
    theta = ae.ravel(params)
    dims = (32, 16, 8, 16, 32)
    with pytest.raises(TypeError):
        lt.train_clients(x, idx.long(), theta, dims, 0.01)
    with pytest.raises(ValueError, match="shape"):
        lt.train_clients(x, idx, theta[:-1], dims, 0.01)
    with pytest.raises(ValueError, match="on cpu"):
        lt.train_clients(x, idx.cpu(), theta, dims, 0.01)
    with pytest.raises(ValueError, match="shared memory"):
        lt.train_clients(torch.zeros((2, 64, 512), device=cuda), idx[:2], torch.zeros(
            ae.param_count(512, (256,)), device=cuda), (512, 256, 512), 0.01)
    deltas, err, fog_id, weights = _agg_case(6, 100, 3, cuda)
    with pytest.raises(TypeError):
        fa.compress_aggregate_blocks(deltas, err, fog_id.long(), weights, 3, 5)
    with pytest.raises(ValueError, match="contiguous"):
        fa.compress_aggregate_blocks(deltas.t().contiguous().t(), err, fog_id, weights, 3, 5)
    with pytest.raises(ValueError, match="shape"):
        fa.compress_aggregate_blocks(deltas, err[:3], fog_id, weights, 3, 5)
    with pytest.raises(ValueError, match="on cpu"):
        fa.compress_aggregate_blocks(deltas, err, fog_id, weights.cpu(), 3, 5)


def test_trial_on_the_card_matches_the_cpu_trial(cuda):
    """A quick-size hfl-selective trial, identical draws on both devices."""
    cfg = exp.make_config(n_sensors=12, n_fog=3, rounds=3, local_epochs=1)
    ds = normalize(generate(torch.Generator().manual_seed(0), SyntheticConfig(
        n_sensors=12, train_len=48, val_len=24, test_len=48), device="cpu"))
    inputs = exp.draw_trial(torch.Generator().manual_seed(1), ds, cfg)
    before = (lt.LAUNCHES["local_train_f32"], fa.LAUNCHES["fused_agg"])
    gpu = exp.trial_metrics("hfl-selective", None, ds, cfg, inputs=inputs)
    torch.cuda.synchronize()
    assert (lt.LAUNCHES["local_train_f32"], fa.LAUNCHES["fused_agg"]) == (
        before[0] + 3, before[1] + 6)
    cpu = exp.trial_metrics("hfl-selective", None, ds, cfg, inputs=inputs, device="cpu")
    assert gpu["losses"].device.type == "cuda"
    for name in ("participation", "coop_links", "e_total", "e_s2f", "e_f2f", "e_f2g"):
        np.testing.assert_allclose(gpu[name].cpu().numpy(), cpu[name].numpy(), rtol=1e-5)
    np.testing.assert_allclose(gpu["losses"].cpu().numpy(), cpu["losses"].numpy(), rtol=1e-4)


@pytest.mark.parametrize("method,kw", [
    ("hfl-selective", dict()),
    ("fedavg", dict()),
    ("hfl-selective", dict(faults=FaultConfig(byz_mode="gauss", byz_frac=0.25, byz_scale=20.0,
                                               erasure_prob=0.3),
                           robust="trimmed", trim_frac=0.45)),
])
def test_engine_run_on_the_card_launches_as_one_trial(cuda, method, kw):
    """An Engine cell of 2 x 2 trials launches each kernel as often as one
    trial does, and its trial (s, 0) agrees with the sequential trial."""
    cfg = exp.make_config(n_sensors=12, n_fog=3, rounds=3, local_epochs=1, **kw)
    ds = normalize(generate(torch.Generator().manual_seed(0), SyntheticConfig(
        n_sensors=12, train_len=48, val_len=24, test_len=48), device="cpu"))
    counts = (lt.LAUNCHES, fa.LAUNCHES, ra.LAUNCHES, q8.LAUNCHES, tk.LAUNCHES)

    def launched(fn):
        before = {k: v for c in counts for k, v in c.items()}
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v - before[k] for c in counts for k, v in c.items()}

    eng = Engine()
    run, cell = launched(lambda: eng.run(method, cfg, (0, 1), ds, n_deployments=2))
    assert eng.take_log()[0]["launches"] == {k: v for k, v in cell.items() if v}
    for s in (0, 1):
        seq, one = launched(lambda: exp.trial_metrics(
            method, torch.Generator().manual_seed(s), ds, eng.resolve_config(cfg)))
        assert cell == one and one["local_train_f32"] == 3
        for name, per in (("participation", 12 * 3), ("coop_links", 3), ("erased_total", 1),
                          ("nonfinite_total", 1)):   # counts exactly
            assert round(float(run[name][s, 0]) * per) == round(float(seq[name]) * per), name
        for name in ("e_total", "e_s2f", "e_f2f", "e_f2g"):
            np.testing.assert_allclose(float(run[name][s, 0]), float(seq[name]), rtol=1e-5)
        np.testing.assert_allclose(run["losses"][s, 0].cpu().numpy(),
                                   seq["losses"].cpu().numpy(), rtol=1e-4)
        assert abs(float(run["f1"][s, 0]) - float(seq["f1"])) <= 1e-3


def _sweep_grid(name):
    from repro_torch.core.async_fl import AsyncFLConfig
    from repro_torch.core.channel import ChannelParams

    base = exp.make_config(n_sensors=12, n_fog=3, rounds=3, local_epochs=1)
    if name == "physics":
        return "hfl-selective", [base.replace(channel=ChannelParams(wind_m_s=w, shipping=s))
                                 for w in (3.0, 8.0) for s in (0.2, 0.7)]
    if name == "robust":
        return "hfl-selective", [base.replace(
            robust="trimmed", trim_frac=0.45, faults=FaultConfig(
                byz_mode="gauss", byz_frac=b, byz_scale=20.0, erasure_prob=p))
            for b in (0.0, 0.25) for p in (0.0, 0.3)]
    return "hfl-async", [AsyncFLConfig(base=base, n_events=8, alpha=a, buffer_k=k)
                         for a in (0.0, 0.5) for k in (2.0, 6.0)]


@pytest.mark.parametrize("name", ["physics", "robust", "async"])
def test_sweep_class_on_the_card_is_one_call_equal_to_its_cells(cuda, name):
    """A sweep class of 4 cells x 2 seeds is one call on the card that
    launches each kernel as often as one of its cells, and each cell
    agrees with its own ``Engine.run`` (counters exactly, energies rtol
    1e-5, losses rtol 1e-4, or 1e-2 for the async and robust cells)."""
    method, cfgs = _sweep_grid(name)
    ds = normalize(generate(torch.Generator().manual_seed(0), SyntheticConfig(
        n_sensors=12, train_len=48, val_len=24, test_len=48), device="cpu"))
    eng = Engine()
    sw = eng.sweep(method, cfgs, (0, 1), ds)
    torch.cuda.synchronize()
    (log,) = eng.take_log()
    assert sw.n_classes == 1 and log["n_cells"] == 4 and sw["f1"].device.type == "cuda"
    loose = 1e-2 if name in ("robust", "async") else 1e-4
    for i, cfg in enumerate(cfgs):
        run = eng.run(method, cfg, (0, 1), ds)
        torch.cuda.synchronize()
        (one,) = eng.take_log()
        assert log["launches"] == one["launches"] and one["launches"]["local_train_f32"] > 0
        got = sw.cell(i)
        for key in ("coop_links", "erased_total", "nonfinite_total", "merges"):
            if key in run.metrics:
                assert torch.equal(got[key], run[key]), key
        for key in ("participation", "e_total", "e_s2f", "e_f2f", "e_f2g"):
            np.testing.assert_allclose(got[key].cpu().numpy(), run[key].cpu().numpy(),
                                       rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(got["losses"].cpu().numpy(), run.losses.cpu().numpy(),
                                   rtol=loose)


def _recon_case(n, d, layout, device, seed=0):
    """Real compressed reconstructions (blockwise rho_s 0.05 int8 through
    the fused_agg kernel): most members tie at exactly 0 in most columns.
    Integer round weights, a quarter of them 0."""
    g = torch.Generator().manual_seed(seed)
    deltas = torch.randn((n, d), generator=g).to(device)
    err = (0.1 * torch.randn((n, d), generator=g)).to(device)
    recon, _ = agg.client_compress(deltas, err, comp.CompressorConfig())
    fog_id, weights = _robust_layout(n, layout, g)
    return recon, fog_id.to(device), weights.to(device)


def _robust_layout(n, layout, g):
    """(fog_id, weights) of a robust case: one fog, 20, half the fleet in
    fog 0, or 1,000 fogs with 3,000 clients in fog 0."""
    if layout == "one":
        fog_id = torch.zeros((n,), dtype=torch.int32)
    elif layout == "fleet":                        # 1,000 fogs; fog 0 holds 3,000 clients
        fog_id = torch.randint(1, 1000, (n,), generator=g, dtype=torch.int32)
        fog_id[:3000] = 0
    elif layout == "half":
        fog_id = torch.randint(1, 20, (n,), generator=g, dtype=torch.int32)
        fog_id[: (n + 1) // 2] = 0
    else:
        fog_id = torch.randint(0, 20, (n,), generator=g, dtype=torch.int32)
    weights = 256.0 * (torch.rand((n,), generator=g) > 0.25).to(torch.float32)
    return fog_id, weights


@pytest.mark.parametrize("layout", ["one", "twenty", "half"])
@pytest.mark.parametrize("n", [1, 13, 200])
@pytest.mark.parametrize("d", [1352, 8209])
def test_robust_agg_kernel_matches_plain(cuda, d, n, layout):
    recon, fog_id, weights = _recon_case(n, d, layout, cuda, seed=n + d)
    for mode, beta in (("trimmed", 0.0), ("trimmed", 0.2), ("trimmed", 0.45), ("median", 0.0)):
        before = ra.LAUNCHES["robust_agg"]
        out = ra.robust_aggregate_blocks(recon, fog_id, weights, 20, beta, mode)
        torch.cuda.synchronize()
        assert ra.LAUNCHES["robust_agg"] == before + 1
        want, _ = ref.robust_aggregate_ref(recon, fog_id, weights, 20, beta, mode)
        np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=f"{mode} {beta}")


@pytest.mark.parametrize("layout", ["one", "twenty", "half", "fleet"])
def test_robust_member_lists_on_the_card_equal_the_plain_lists(cuda, layout):
    """The lists ``robust_agg``'s first launch builds (``member_lists_blocks``)
    equal ``member_lists``, the plain version, element for element: members
    and offsets, with ids outside [0, n_fog) and zero and negative weights
    among the clients (both put every client of no fog last, in index
    order)."""
    n, n_fog = (30_000, 1000) if layout == "fleet" else (2000, 20)
    fog_id, weights = _robust_layout(n, layout, torch.Generator().manual_seed(n + n_fog))
    fog_id[::97], fog_id[5::101], fog_id[7::103] = -3, n_fog, n_fog + 9
    weights[3::89] = -1.0
    fog_id, weights = fog_id.to(cuda), weights.to(cuda)
    before = ra.LAUNCHES["robust_agg"]
    members, offsets = ra.member_lists_blocks(fog_id, weights, n_fog)
    want_members, want_offsets = ra.member_lists(fog_id, weights, n_fog)
    torch.cuda.synchronize()
    assert ra.LAUNCHES["robust_agg"] == before          # the list alone is not a robust_agg call
    assert torch.equal(offsets, want_offsets) and torch.equal(members, want_members)


def test_robust_agg_kernel_takes_any_fleet_size(cuda):
    """N = 30,000 clients in 1,000 fogs, one of them holding 3,000: the
    kernel reads a compacted member list, so neither the fleet nor the
    large fog (streamed through shared memory in tiles) is too big."""
    recon, fog_id, weights = _recon_case(30_000, 1352, "fleet", cuda, seed=3)
    for mode, beta in (("trimmed", 0.45), ("median", 0.0)):
        out = ra.robust_aggregate_blocks(recon, fog_id, weights, 1000, beta, mode)
        want, _ = ref.robust_aggregate_ref(recon, fog_id, weights, 1000, beta, mode)
        np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=f"{mode} {beta}")


def test_kernels_take_more_fogs_than_grid_rows(cuda):
    """n_fog = 66,000, past the grid's 65,535 rows: ``fused_agg`` with
    identity segments (one fog per client, as the robust path compresses;
    its fog sums bitwise the client-order fold),
    ``robust_agg`` with three populated fogs, two of them past the grid's
    rows, each against its plain version, and ``wire_agg`` into those three
    fogs bitwise equal to the client-order fold, the other rows untouched."""
    n, d = 66_000, 64
    deltas, err, _, weights = _agg_case(n, d, 3, cuda, seed=11)
    ids = torch.arange(n, dtype=torch.int32, device=cuda)
    fog_sum, new_err, _ = fa.compress_aggregate_blocks(deltas, err, ids, weights, n, 3)
    assert torch.equal(fog_sum, ref.dense_fold_ref(deltas, err, ids, weights, n, 3))
    fs_ref, ne_ref, _ = ref.compress_aggregate_ref(deltas, err, ids, weights, n, 3)
    np.testing.assert_allclose(new_err.cpu().numpy(), ne_ref.cpu().numpy(), atol=1e-5)
    np.testing.assert_allclose(fog_sum.cpu().numpy(), fs_ref.cpu().numpy(), rtol=1e-5, atol=1e-4)
    populated = torch.tensor([0, 65_600, 65_999], dtype=torch.int32, device=cuda)
    small = torch.randint(0, 3, (n,), generator=torch.Generator().manual_seed(2),
                          dtype=torch.int32).to(cuda)
    weights = torch.zeros((n,), device=cuda)
    weights[::200] = 256.0                     # ~110 members per populated fog
    out = ra.robust_aggregate_blocks(deltas, populated[small.long()], weights, n, 0.2)
    want = torch.zeros((n, d), device=cuda)
    want[populated.long()] = ref.robust_aggregate_ref(deltas, small, weights, 3, 0.2)[0]
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-6)
    idx, q, scale, _ = fa.compress_wire_blocks(deltas[:3000], err[:3000], 3)
    fogs = populated[small[:3000].long()]
    base = torch.randn((n, d), generator=torch.Generator().manual_seed(3)).to(cuda)
    got = fa.wire_aggregate_blocks(idx, q, scale, fogs, weights[:3000], n, d, out=base.clone())
    assert torch.equal(got, ref.wire_fold_ref(idx, q, scale, fogs, weights[:3000], base.clone()))
    others = torch.ones((n,), dtype=torch.bool, device=cuda)
    others[populated.long()] = False
    assert torch.equal(got[others], base[others])


def test_fleet_shapes_match_plain(cuda):
    """The kernels at fleet-10k's shapes (N = 10,000, d = 1,352, 1,000
    fogs, k = 68, int8): ``fused_agg`` unchunked (its fog sums bitwise the
    client-order fold), and the wire pair chunk by chunk (512 clients) into
    running fog sums, each against its plain version."""
    n, d, n_fog, chunk = 10_000, 1352, 1000, 512
    deltas, err, fog_id, weights = _agg_case(n, d, n_fog, cuda, seed=10)
    k = ops.wire_k(comp.blockwise_k_frac(d, 0.05))
    fog_sum, new_err, thr = fa.compress_aggregate_blocks(deltas, err, fog_id, weights, n_fog, k)
    assert torch.equal(fog_sum, ref.dense_fold_ref(deltas, err, fog_id, weights, n_fog, k))
    fs_ref, ne_ref, thr_ref = ref.compress_aggregate_ref(deltas, err, fog_id, weights, n_fog, k)
    absv = ref.pad_blocks(deltas + err).abs()
    assert torch.equal(absv > thr[..., None], absv > thr_ref[..., None])
    np.testing.assert_allclose(new_err.cpu().numpy(), ne_ref.cpu().numpy(), atol=1e-5)
    np.testing.assert_allclose(fog_sum.cpu().numpy(), fs_ref.cpu().numpy(), rtol=1e-5, atol=1e-4)
    run = torch.zeros((n_fog, d), device=cuda)
    run_ref = torch.zeros((n_fog, d), device=cuda)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        idx, q, scale, ne = fa.compress_wire_blocks(deltas[s:e], err[s:e], k)
        w_idx, w_q, w_scale, w_err = ref.compress_wire_ref(deltas[s:e], err[s:e], k)
        assert torch.equal(idx, w_idx) and torch.equal(q, w_q) and torch.equal(scale, w_scale)
        np.testing.assert_allclose(ne.cpu().numpy(), w_err.cpu().numpy(), atol=1e-5)
        fa.wire_aggregate_blocks(idx, q, scale, fog_id[s:e], weights[s:e], n_fog, d, out=run)
        run_ref += ref.wire_aggregate_ref(idx, q, scale, fog_id[s:e], weights[s:e], n_fog, d)
        np.testing.assert_allclose(run.cpu().numpy(), run_ref.cpu().numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("k", [68, 410])
@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("n", [1, 200])
@pytest.mark.parametrize("d", [1352, 8209, 65536])
def test_wire_kernels_match_plain(cuda, d, n, quantize, k):
    deltas, err, fog_id, weights = _agg_case(n, d, 20, cuda, seed=d + n + k)
    nb, off = -(-d // 8192), 3                 # write at a row offset of larger buffers
    bufs = (torch.full((n + 5, nb, k), -7, dtype=torch.int32, device=cuda),
            torch.full((n + 5, nb, k), 5, dtype=torch.int8 if quantize else torch.float32,
                       device=cuda),
            torch.full((n + 5, nb), 9.0, device=cuda), torch.full((n + 5, d), 9.0, device=cuda))
    before = (fa.LAUNCHES["wire_emit"], fa.LAUNCHES["wire_agg"])
    fa.compress_wire_blocks(deltas, err, k, quantize, out=tuple(b[off:off + n] for b in bufs))
    idx, q, scale, new_err = (b[off:off + n] for b in bufs)
    w_idx, w_q, w_scale, w_err = ref.compress_wire_ref(deltas, err, k, quantize)
    assert torch.equal(idx, w_idx) and torch.equal(q, w_q) and torch.equal(scale, w_scale)
    assert torch.equal(new_err, w_err)
    for b, fill in zip(bufs, (-7, 5, 9.0, 9.0)):            # rows outside untouched
        assert bool((b[:off] == fill).all()) and bool((b[off + n:] == fill).all())
    base = torch.randn((20, d), generator=torch.Generator().manual_seed(1)).to(cuda)
    fog_sum = fa.wire_aggregate_blocks(idx, q, scale, fog_id, weights, 20, d, out=base.clone())
    torch.cuda.synchronize()
    assert (fa.LAUNCHES["wire_emit"], fa.LAUNCHES["wire_agg"]) == (before[0] + 1, before[1] + 1)
    want = base + ref.wire_aggregate_ref(idx, q, scale, fog_id, weights, 20, d)
    np.testing.assert_allclose(fog_sum.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-4)
    assert torch.equal(fog_sum[1], base[1])                # the empty fog's row untouched
    assert torch.equal(fog_sum, ref.wire_fold_ref(idx, q, scale, fog_id, weights, base.clone()))


@pytest.mark.parametrize("quantize", [True, False])
def test_wire_agg_bitwise_at_a_10k_client_call(cuda, quantize):
    """One call of 10,000 clients into 1,000 fogs (fleet-10k's whole round
    in one call, ~10 clients a fog in 20 batches of the member scan), k =
    68: bitwise equal to the client-order fold from running sums."""
    n, d, n_fog = 10_000, 1352, 1000
    deltas, err, fog_id, weights = _agg_case(n, d, n_fog, cuda, seed=12)
    idx, q, scale, _ = fa.compress_wire_blocks(deltas, err, 68, quantize)
    base = torch.randn((n_fog, d), generator=torch.Generator().manual_seed(4)).to(cuda)
    got = fa.wire_aggregate_blocks(idx, q, scale, fog_id, weights, n_fog, d, out=base.clone())
    assert torch.equal(got, ref.wire_fold_ref(idx, q, scale, fog_id, weights, base.clone()))
    assert torch.equal(got[1], base[1])


def _wire_rows(n, d, k, device, seed):
    """Gaussian rows; with N > 2, row 1 all zeros and row 2 with more than
    k entries of each block tied at its max (as many as its width allows)
    and the rest tied at a tenth of it."""
    g = torch.Generator().manual_seed(seed)
    deltas = torch.randn((n, d), generator=g)
    err = 0.1 * torch.randn((n, d), generator=g)
    if n > 2:
        deltas[1] = 0.0
        err[1] = 0.0
        err[2] = 0.0
        deltas[2] = torch.where(torch.arange(d) % 2 == 0, 0.5, -0.5)
        for lo in range(0, d, 8192):
            t = min(d - lo, 8192, k + 3)
            deltas[2, lo:lo + t] = torch.where(torch.arange(t) % 2 == 0, 5.0, -5.0)
    return deltas.to(device), err.to(device)


def _assert_wire_equal(deltas, err, k, quantize):
    got = fa.compress_wire_blocks(deltas, err, k, quantize)
    want = ref.compress_wire_ref(deltas, err, k, quantize)
    for g, w, what in zip(got, want, ("idx", "q", "scale", "new_err")):
        assert g.dtype == w.dtype and torch.equal(g, w), what
    return got


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("d", [1, 31, 33, 1352, 2049, 8191, 8192, 8209, 65536])
def test_wire_emit_bitwise_over_widths(cuda, d, quantize):
    """Warp teams (widths up to 2,048), block teams and both in one launch
    (8,209 = a full block and a 17-wide one), N = 7 with a zero row and a
    tied row, k = 68."""
    deltas, err = _wire_rows(7, d, 68, cuda, seed=d)
    _assert_wire_equal(deltas, err, 68, quantize)


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("d,k", [(8209, 1), (8209, 68), (31, 68), (1352, 1352), (1352, 2048),
                                 (2049, 4096), (8209, 8192), (1, 8192)])
def test_wire_emit_edges(cuda, d, k, quantize):
    """k = 1; k = 68 at d = 8,209, whose fill reaches past the 17-wide last
    block's real columns into its padding; k at and above a block's real
    width; k = 8,192, where every position survives."""
    deltas, err = _wire_rows(5, d, k, cuda, seed=d + k)
    _assert_wire_equal(deltas, err, k, quantize)


def test_wire_emit_new_err_equals_compress_q8(cuda):
    """Two kernels on the one selection (team_threshold), each with its own
    launch and writes: wire_emit's new_err equals compress_q8's bit for
    bit on the same rows."""
    for d in (1352, 8209):
        deltas, err = _wire_rows(200, d, 68, cuda, seed=d + 1)
        _, _, _, wire_err = fa.compress_wire_blocks(deltas, err, 68)
        _, _, q8_err = q8.compress_blocks(deltas, err, 68)
        assert torch.equal(wire_err, q8_err)


def _assert_compressor_equal(deltas, err, k, kernel):
    """The kernel's outputs bitwise its plain version's (floats compared by
    their bits)."""
    if kernel == "compress_q8":
        got, want = q8.compress_blocks(deltas, err, k), ref.compress_ref(deltas, err, k)
    else:
        got, want = tk.topk_ef_blocks(deltas, err, k), ref.blockwise_topk_ef_ref(deltas, err, k)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)
    return got


@pytest.mark.parametrize("kernel", ["compress_q8", "topk_ef"])
@pytest.mark.parametrize("d", [1, 31, 33, 1352, 2048, 2049, 8191, 8192, 8209, 65536])
def test_compressor_kernels_bitwise_over_widths(cuda, d, kernel):
    """Small teams (widths up to 2,048, every slot count), block teams and
    both in one launch (8,209 = a full block and a 17-wide one), N = 7
    with a zero row and a tied row, k = 68."""
    deltas, err = _wire_rows(7, d, 68, cuda, seed=d)
    _assert_compressor_equal(deltas, err, 68, kernel)


@pytest.mark.parametrize("kernel", ["compress_q8", "topk_ef"])
@pytest.mark.parametrize("d,k", [(8209, 1), (1352, 1), (31, 68), (1352, 1352), (1352, 2048),
                                 (2049, 4096), (8209, 8000), (8209, 8192), (1, 8192),
                                 (1352, 68)])
def test_compressor_kernels_edges(cuda, d, k, kernel):
    """k = 1; k at and above a block's real width; k = 8,000 on a 17-wide
    block, where the count at mid < 0 hangs on every zero of the padding;
    k = 8,192, where every position survives; an all-zero row (no codes, scale 0); a row tying
    more than k entries at each block max, where nothing survives
    (compress_q8: scale 0 and no codes; fused_agg keeps the max's scale)."""
    deltas, err = _wire_rows(5, d, k, cuda, seed=d + k)
    got = _assert_compressor_equal(deltas, err, k, kernel)
    if kernel != "compress_q8":
        return
    q, scale, _ = got
    assert not q[1].any() and not scale[1].any()
    for b, lo in enumerate(range(0, d, 8192)):
        if min(d - lo, 8192, k + 3) > k:
            assert float(scale[2, b]) == 0.0 and not q[2, lo:lo + 8192].any()


def test_ops_route_robust_and_wire_tensors_to_the_kernels(cuda):
    deltas, err, fog_id, weights = _agg_case(12, 1352, 3, cuda)
    before = (ra.LAUNCHES["robust_agg"], fa.LAUNCHES["wire_emit"], fa.LAUNCHES["wire_agg"])
    ops.robust_aggregate(deltas, fog_id, weights, 3, 0.2)
    ops.compress_aggregate_wire(deltas, err, fog_id, weights, 3, 0.05)
    torch.cuda.synchronize()
    assert (ra.LAUNCHES["robust_agg"], fa.LAUNCHES["wire_emit"], fa.LAUNCHES["wire_agg"]) == (
        before[0] + 1, before[1] + 1, before[2] + 1)


def test_robust_and_wire_wrappers_check_inputs(cuda):
    deltas, err, fog_id, weights = _agg_case(6, 100, 3, cuda)
    with pytest.raises(ValueError, match="mode"):
        ra.robust_aggregate_blocks(deltas, fog_id, weights, 3, 0.2, "krum")
    with pytest.raises(TypeError):
        ra.robust_aggregate_blocks(deltas, fog_id.long(), weights, 3, 0.2)
    with pytest.raises(ValueError, match="on cpu"):
        ra.robust_aggregate_blocks(deltas, fog_id, weights.cpu(), 3, 0.2)
    with pytest.raises(ValueError, match="k"):
        fa.compress_wire_blocks(deltas, err, 8193)
    with pytest.raises(ValueError, match="contiguous"):
        fa.compress_wire_blocks(deltas.t().contiguous().t(), err, 5)
    idx, q, scale, _ = fa.compress_wire_blocks(deltas, err, 5)
    with pytest.raises(ValueError, match="shape"):
        fa.compress_wire_blocks(deltas, err, 5, out=(idx, q, scale, err[:3]))
    with pytest.raises(TypeError):
        fa.wire_aggregate_blocks(idx, q.to(torch.int32), scale, fog_id, weights, 3, 100)
    with pytest.raises(ValueError, match="blocks"):
        fa.wire_aggregate_blocks(idx, q, scale, fog_id, weights, 3, 9000)
    with pytest.raises(ValueError, match="n_fog"):
        fa.wire_aggregate_blocks(idx, q, scale, fog_id, weights, 0, 100)


ASYNC_CELLS = {   # name -> (round-config overrides, async knobs)
    "default": (dict(), dict(buffer_k=4.0, fog_k=1.0, alpha=0.5)),
    "robust": (dict(robust="trimmed", trim_frac=0.3, client_chunk=5,
                    faults=FaultConfig(byz_mode="gauss", byz_frac=0.25, byz_scale=5.0,
                                       erasure_prob=0.3, crash_prob=0.2)),
               dict(buffer_k=4.0, fog_k=2.0, alpha=0.5)),
    "replay": (dict(server_opt="adam"),
               dict(buffer_k=4.0, fog_k=2.0, alpha=1.0, tau_max=2.0,
                    arrival_delay_s=torch.linspace(0.5, 3.0, 12).flip(0))),
}


def _async_cfg(name, n_events=8):
    from repro_torch.core.async_fl import AsyncFLConfig
    over, knobs = ASYNC_CELLS[name]
    return AsyncFLConfig(base=exp.make_config(n_sensors=12, n_fog=3, rounds=3, local_epochs=1,
                                              **over), n_events=n_events, **knobs)


def _launch_counts():
    return {k: v for c in (lt.LAUNCHES, fa.LAUNCHES, ra.LAUNCHES, q8.LAUNCHES, tk.LAUNCHES)
            for k, v in c.items()}


@pytest.mark.parametrize("name", list(ASYNC_CELLS))
def test_async_events_on_the_card_match_the_cpu(cuda, name):
    """An hfl-async trial on the card and on the CPU from identical draws:
    every event's merge, launches, arrivals and erasures exactly, energies
    and the clock to rtol 1e-5, losses to rtol 1e-4; one
    ``local_train_f32`` and one ``fused_agg`` call (two launches) an event,
    and one ``robust_agg`` with the trimmed reduce."""
    from repro_torch.core import async_fl
    acfg = _async_cfg(name)
    ds = normalize(generate(torch.Generator().manual_seed(0), SyntheticConfig(
        n_sensors=12, train_len=48, val_len=24, test_len=48), device="cpu"))
    inputs = exp.draw_trial(torch.Generator().manual_seed(1), ds, acfg, method="hfl-async")
    before = _launch_counts()
    _, m_g = async_fl.train(inputs.params, ae.loss, ds._replace(**{
        k: v.to(cuda) for k, v in ds._asdict().items()}), acfg, inputs.dep, inputs.draws)
    torch.cuda.synchronize()
    after = _launch_counts()
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    want = {"local_train_f32": 8, "fused_agg": 16}
    if name == "robust":
        want = {"local_train_f32": 8, "fused_agg": 48, "robust_agg": 8}   # 3 chunks of 5 an event
    assert launched == want
    _, m_c = async_fl.train(inputs.params, ae.loss, ds, acfg, inputs.dep, inputs.draws)
    assert m_g.loss.device.type == "cuda"
    for field in ("merged", "n_launched", "n_arrived", "n_erased", "coop_links",
                  "n_nonfinite", "global_finite"):
        np.testing.assert_array_equal(getattr(m_g, field).cpu().numpy(),
                                      getattr(m_c, field).numpy(), err_msg=field)
    for field in ("e_s2f", "e_f2f", "e_f2g", "e_total", "t_sim", "event_s", "latency_s",
                  "participation", "battery_min"):
        np.testing.assert_allclose(getattr(m_g, field).cpu().numpy(),
                                   getattr(m_c, field).numpy(), rtol=1e-5, err_msg=field)
    np.testing.assert_allclose(m_g.loss.cpu().numpy(), m_c.loss.numpy(), rtol=1e-4)
    np.testing.assert_allclose(m_g.staleness.cpu().numpy(), m_c.staleness.numpy(), rtol=1e-6)
    assert bool(m_c.merged.any()) and not bool(m_c.merged.all())


@pytest.mark.parametrize("name", ["default", "robust"])
def test_async_engine_cell_launches_as_one_trial(cuda, name):
    """An hfl-async Engine cell of 2 x 2 trials launches each kernel as
    often as one trial does, and its trials (s, 0) agree with sequential
    card trials."""
    acfg = _async_cfg(name)
    ds = normalize(generate(torch.Generator().manual_seed(0), SyntheticConfig(
        n_sensors=12, train_len=48, val_len=24, test_len=48), device="cpu"))
    eng = Engine()
    before = _launch_counts()
    run = eng.run("hfl-async", acfg, (0, 1), ds, n_deployments=2)
    torch.cuda.synchronize()
    cell = {k: v - before[k] for k, v in _launch_counts().items()}
    assert eng.take_log()[0]["launches"] == {k: v for k, v in cell.items() if v}
    if name == "default":
        assert cell["local_train_f32"] == 8 and cell["fused_agg"] == 16
    for s in (0, 1):
        before = _launch_counts()
        seq = exp.trial_metrics("hfl-async", torch.Generator().manual_seed(s), ds,
                                eng.resolve_config(acfg))
        torch.cuda.synchronize()
        one = {k: v - before[k] for k, v in _launch_counts().items()}
        if name == "default":
            assert cell == one
        else:   # the chunked compressor walks B * N rows: 48 / 5 chunks against 12 / 5
            assert {k: cell[k] for k in ("local_train_f32", "robust_agg")} == {
                k: one[k] for k in ("local_train_f32", "robust_agg")}
        for key, per in (("participation", 12 * 8), ("coop_links", 8), ("erased_total", 1),
                         ("merges", 1), ("nonfinite_total", 1)):
            assert round(float(run[key][s, 0]) * per) == round(float(seq[key]) * per), key
        for key in ("e_total", "e_s2f", "e_f2f", "e_f2g", "sim_time_s", "staleness"):
            np.testing.assert_allclose(float(run[key][s, 0]), float(seq[key]), rtol=1e-5)
        np.testing.assert_allclose(run["losses"][s, 0].cpu().numpy(),
                                   seq["losses"].cpu().numpy(), rtol=1e-4)
        assert abs(float(run["f1"][s, 0]) - float(seq["f1"])) <= 1e-3


@pytest.mark.parametrize("kw", [
    dict(robust="trimmed", trim_frac=0.3,
         faults=FaultConfig(byz_mode="gauss", byz_frac=0.25, byz_scale=20.0, erasure_prob=0.3)),
    dict(client_chunk=5),
])
def test_robust_and_chunked_trials_on_the_card_match_the_cpu(cuda, kw):
    cfg = exp.make_config(n_sensors=12, n_fog=3, rounds=3, local_epochs=1, **kw)
    ds = normalize(generate(torch.Generator().manual_seed(0), SyntheticConfig(
        n_sensors=12, train_len=48, val_len=24, test_len=48), device="cpu"))
    inputs = exp.draw_trial(torch.Generator().manual_seed(1), ds, cfg)
    gpu = exp.trial_metrics("hfl-selective", None, ds, cfg, inputs=inputs)
    cpu = exp.trial_metrics("hfl-selective", None, ds, cfg, inputs=inputs, device="cpu")
    for name in ("participation", "coop_links", "erased_total", "e_total", "e_s2f"):
        np.testing.assert_allclose(gpu[name].cpu().numpy(), cpu[name].numpy(), rtol=1e-5)
    np.testing.assert_allclose(gpu["losses"].cpu().numpy(), cpu["losses"].numpy(), rtol=1e-4)


def _compress_case(n, d, k, device, seed=0):
    """Gaussian rows; with n > 2, row 1 all zeros and row 2 tying more than
    k entries of each block at the block max (as the block's width
    allows)."""
    g = torch.Generator().manual_seed(seed)
    deltas = torch.randn((n, d), generator=g)
    err = 0.1 * torch.randn((n, d), generator=g)
    if n > 2:
        deltas[1] = err[1] = 0.0
        deltas[2] *= 0.1
        err[2] = 0.0
        for lo in range(0, d, 8192):
            t = min(d - lo, 8192, k + 3)
            deltas[2, lo:lo + t] = torch.where(torch.arange(t) % 2 == 0, 5.0, -5.0)
    return deltas.to(device), err.to(device)


@pytest.mark.parametrize("rho_s", [0.05, 1.0, 1.0 / 8192])
@pytest.mark.parametrize("n", [1, 200])
@pytest.mark.parametrize("d", [1352, 8209, 65536])
def test_compressor_kernels_match_plain(cuda, d, n, rho_s):
    k = ops.block_k(comp.blockwise_k_frac(d, rho_s))
    deltas, err = _compress_case(n, d, k, cuda, seed=d + n)
    before = (q8.LAUNCHES["compress_q8"], tk.LAUNCHES["topk_ef"])
    q, scale, new_err = q8.compress_blocks(deltas, err, k)
    sparse, t_err = tk.topk_ef_blocks(deltas, err, k)
    torch.cuda.synchronize()
    assert (q8.LAUNCHES["compress_q8"], tk.LAUNCHES["topk_ef"]) == (before[0] + 1, before[1] + 1)
    for got, want in zip((q, scale, new_err, sparse, t_err),
                         (*ref.compress_ref(deltas, err, k),
                          *ref.blockwise_topk_ef_ref(deltas, err, k))):
        assert got.dtype == want.dtype and torch.equal(got, want)
    if n > 2:
        assert not q[1].any() and not scale[1].any()


def test_compressor_tie_keeps_nothing_on_the_card(cuda):
    deltas, err = _compress_case(200, 1352, 68, cuda, seed=3)
    q, scale, new_err = q8.compress_blocks(deltas, err, 68)
    assert float(scale[2, 0]) == 0.0 and not q[2].any() and torch.equal(new_err[2], deltas[2])
    _, _, thr = fa.compress_aggregate_blocks(
        deltas, err, torch.zeros(200, dtype=torch.int32, device=cuda),
        torch.ones(200, device=cuda), 1, 68)
    assert float(thr[2, 0]) == 5.0


@pytest.mark.parametrize("n,d", [(1, 1 << 20), (3, 1352), (200, 8209)])
def test_quant8_kernel_matches_plain(cuda, n, d):
    g = torch.Generator().manual_seed(n)
    x = (torch.randn((n, d), generator=g) * 10.0 ** (6 * torch.rand((n, 1), generator=g) - 3))
    x[0, :100] = 0.0
    if n > 1:
        x[1] = 0.0
    x = x.to(cuda)
    before = q8.LAUNCHES["quant8"]
    q, scale = q8.quant8_blocks(x)
    torch.cuda.synchronize()
    assert q8.LAUNCHES["quant8"] == before + 1
    q_ref, scale_ref = ref.quant8_ref(x)
    assert torch.equal(q, q_ref) and torch.equal(scale, scale_ref)


@pytest.mark.parametrize("n,d,offset", [
    (1, 1 << 20, 0), (200, 1352, 0), (200, 8209, 0), (5, 8209, 1), (3, 4097, 3), (2, 16385, 2),
    (7, 1, 0), (4, 8192, 1), (2, 1 << 16, 0), (3, 3, 1), (9, 5, 2), (2, 8191, 3), (1, 33, 1)])
def test_quant8_kernel_bitwise_at_any_alignment(cuda, n, d, offset):
    """The phase-6 shapes, widths that are not a multiple of 4, rows that
    start off a 16-byte boundary (a contiguous view ``offset`` floats into
    its buffer, so the first and last chunks straddle the tensor's ends),
    an all-zero block and an all-zero row: codes (padding zeros included)
    and scales bitwise the plain version's."""
    g = torch.Generator().manual_seed(n * 7 + d)
    buf = torch.randn((n * d + offset,), generator=g)
    x = buf[offset:].view(n, d)
    x.mul_(10.0 ** (6 * torch.rand((n, 1), generator=g) - 3))
    x[0, :min(d, 8192)] = 0.0
    if n > 1:
        x[-1] = 0.0
    buf = buf.to(cuda)
    x = buf[offset:].view(n, d)
    assert x.is_contiguous() and (x.data_ptr() % 16 == 0) == (offset % 4 == 0)
    before = q8.LAUNCHES["quant8"]
    q, scale = q8.quant8_blocks(x)
    torch.cuda.synchronize()
    assert q8.LAUNCHES["quant8"] == before + 1
    q_ref, scale_ref = ref.quant8_ref(x)
    assert torch.equal(q, q_ref) and torch.equal(scale, scale_ref)
    assert float(scale[0, 0]) == 0.0


def test_quant8_kernel_bitwise_near_half_codes(cuda):
    """Values whose quotient by the scale lies at or next to a half-integer
    (where the kernel divides instead of multiplying by the reciprocal),
    tiny scales (a subnormal scale's reciprocal overflows) and huge ones."""
    rows = []
    for amax in (127.0, 1.0, 3.0e-38, 1.0e-40, 3.0e38):
        s = np.float32(amax) * np.float32(1.0 / 127.0)
        k = np.arange(-127, 128, dtype=np.float32)
        half = (k + np.float32(0.5)) * s
        near = np.concatenate([half, np.nextafter(half, np.float32(np.inf)),
                               np.nextafter(half, np.float32(-np.inf)), k * s])
        row = np.zeros(2048, np.float32)
        row[:near.size] = np.clip(near, -amax, amax)
        row[-1] = amax
        rows.append(row)
    x = torch.from_numpy(np.stack(rows)).to(cuda)
    q, scale = q8.quant8_blocks(x)
    q_ref, scale_ref = ref.quant8_ref(x)
    assert torch.equal(q, q_ref) and torch.equal(scale, scale_ref)


def test_ops_route_compressor_tensors_to_the_kernels(cuda):
    deltas, err = _compress_case(12, 1352, 68, cuda)
    before = (q8.LAUNCHES["compress_q8"], q8.LAUNCHES["quant8"], tk.LAUNCHES["topk_ef"])
    recon, new_err, bits = ops.compress(deltas, err, 0.05)
    ops.topk_ef(deltas, err, 0.05)
    q, scale, n = ops.quant8(deltas)
    torch.cuda.synchronize()
    assert (q8.LAUNCHES["compress_q8"], q8.LAUNCHES["quant8"], tk.LAUNCHES["topk_ef"]) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    want = ops.compress(deltas.cpu(), err.cpu(), 0.05)
    for got, w in zip((recon, new_err, bits), want):
        assert torch.equal(got.cpu(), w)
    assert torch.equal(ops.dequant8(q, scale, n).cpu(),
                       ops.dequant8(*ops.quant8(deltas.cpu())))


def test_compressor_wrappers_check_inputs(cuda):
    deltas, err = _compress_case(6, 100, 5, cuda)
    with pytest.raises(ValueError, match="k"):
        q8.compress_blocks(deltas, err, 8193)
    with pytest.raises(TypeError):
        q8.compress_blocks(deltas.double(), err, 5)
    with pytest.raises(ValueError, match="contiguous"):
        tk.topk_ef_blocks(deltas.t().contiguous().t(), err, 5)
    with pytest.raises(ValueError, match="shape"):
        tk.topk_ef_blocks(deltas, err[:3], 5)
    with pytest.raises(ValueError, match="on cpu"):
        q8.compress_blocks(deltas, err.cpu(), 5)
    with pytest.raises(ValueError, match="rows"):
        q8.quant8_blocks(deltas[0])
    with pytest.raises(ValueError, match="CUDA"):
        q8.quant8_blocks(deltas.cpu())


@pytest.mark.parametrize("kw,kernel,per_round", [
    (dict(compressor=comp.CompressorConfig(fused=False)), "compress_q8", 1),
    (dict(compressor=comp.CompressorConfig(fused=False, quant_bits=32)), "topk_ef", 1),
    (dict(compressor=comp.CompressorConfig(rho_s=1.0)), "compress_q8", 1),
    (dict(drift=DriftConfig(sensor_current_m_s=3.0, reassoc_every=2.0)), "fused_agg", 2),
])
def test_per_client_and_drift_trials_on_the_card_match_the_cpu(cuda, kw, kernel, per_round):
    cfg = exp.make_config(n_sensors=12, n_fog=3, rounds=3, local_epochs=1, **kw)
    ds = normalize(generate(torch.Generator().manual_seed(0), SyntheticConfig(
        n_sensors=12, train_len=48, val_len=24, test_len=48), device="cpu"))
    inputs = exp.draw_trial(torch.Generator().manual_seed(1), ds, cfg)
    counts = {"compress_q8": q8.LAUNCHES, "topk_ef": tk.LAUNCHES, "fused_agg": fa.LAUNCHES}
    before = counts[kernel][kernel]
    gpu = exp.trial_metrics("hfl-selective", None, ds, cfg, inputs=inputs)
    torch.cuda.synchronize()
    assert counts[kernel][kernel] == before + 3 * per_round
    cpu = exp.trial_metrics("hfl-selective", None, ds, cfg, inputs=inputs, device="cpu")
    for name in ("participation", "coop_links", "e_total", "e_s2f"):
        np.testing.assert_allclose(gpu[name].cpu().numpy(), cpu[name].numpy(), rtol=1e-5)
    np.testing.assert_allclose(gpu["losses"].cpu().numpy(), cpu["losses"].numpy(), rtol=1e-4)


# --- sliding-window decode attention (swa_decode) and LM decode -------------

SWA_F32_TOL = dict(atol=2e-5, rtol=1e-4)


def _swa_inputs(b, hq, hkv, d, s, lens, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, hq, d), generator=g).to(device, dtype)
    k = torch.randn((b, s, hkv, d), generator=g).to(device, dtype)
    v = torch.randn((b, s, hkv, d), generator=g).to(device, dtype)
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=device)


def _assert_swa_close(got, want):
    """f32 to the reference's kernel tolerance; bf16 equal or one ulp apart
    (within f32's atol near zero, where f32 rounding spans bf16 ulps)."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, **SWA_F32_TOL)
        return
    def ordered(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits & 0x7FFF)
    ulps = torch.abs(ordered(got) - ordered(want))
    near = torch.abs(got.float() - want.float()) <= SWA_F32_TOL["atol"]
    assert bool(torch.all((ulps <= 1) | near))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [64, 2048, 2 ** 30])
@pytest.mark.parametrize("s", [64, 2233])
@pytest.mark.parametrize("hq,hkv,d", [(10, 1, 256), (32, 8, 128), (8, 8, 64), (36, 2, 32)])
def test_swa_decode_kernel_matches_plain(cuda, hq, hkv, d, s, window, dtype):
    lens = [1, min(window - 1, s), min(window, s), min(window + 1, s), s, s + window]
    q, k, v, ln = _swa_inputs(len(lens), hq, hkv, d, s, lens, dtype, cuda, seed=s + d)
    got = ops.swa_decode_attention(q, k, v, ln, window)
    want = ref.sliding_window_decode_attention_ref(q, k, v, ln, window)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    _assert_swa_close(got, want)
    assert bool(torch.all(got[-1] == 0))          # len >= S + window: empty window


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [5, 64, 2048])
@pytest.mark.parametrize("hq,hkv,d", [(8, 8, 64), (10, 1, 256), (32, 2, 128), (36, 1, 32)])
def test_swa_decode_split_edges(cuda, hq, hkv, d, window, dtype):
    """g = 1, 10, 16, 36; a window shorter than one tile (5); rows whose
    window fills only the first of many splits (len 1, 5), ends mid-split,
    or is empty (len = S + window)."""
    from repro_torch.kernels import swa_attention as swa
    s = 2233
    lens = [1, 5, window + 3, 1000, s, s + window]
    splits, chunk = swa.plan(len(lens), hq, s, hkv, window)
    assert splits > 1 or window < swa.TILE
    q, k, v, ln = _swa_inputs(len(lens), hq, hkv, d, s, lens, dtype, cuda, seed=hq + window)
    got = swa.swa_decode(q, k, v, ln, window)
    want = ref.sliding_window_decode_attention_ref(q, k, v, ln, window)
    torch.cuda.synchronize()
    _assert_swa_close(got, want)
    assert bool(torch.all(got[-1] == 0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_decode_is_deterministic(cuda, dtype):
    """The splits merge in a fixed order: two calls bitwise equal."""
    from repro_torch.kernels import swa_attention as swa
    lens = [2200, 77, 1, 2049, 2233, 300, 1500, 4000]
    q, k, v, ln = _swa_inputs(8, 10, 1, 256, 2233, lens, dtype, cuda, seed=3)
    first = swa.swa_decode(q, k, v, ln, 2048)
    for _ in range(3):
        assert torch.equal(swa.swa_decode(q, k, v, ln, 2048), first)


def test_swa_decode_ignores_positions_outside_the_window_bitwise(cuda):
    lens, window = [300, 77], 64
    q, k, v, ln = _swa_inputs(2, 10, 1, 256, 512, lens, torch.bfloat16, cuda)
    base = ops.swa_decode_attention(q, k, v, ln, window)
    k2, v2 = k.clone(), v.clone()
    for row, n in enumerate(lens):
        k2[row, :n - window] += 100.0
        v2[row, n:] = 1e4
    torch.testing.assert_close(ops.swa_decode_attention(q, k2, v2, ln, window), base,
                               rtol=0, atol=0)


def test_swa_decode_wrapper_checks_inputs_and_counts(cuda):
    from repro_torch.kernels import swa_attention as swa
    q, k, v, ln = _swa_inputs(2, 8, 2, 64, 96, [96, 10], torch.float32, cuda)
    swa.reset_launches()
    ops.swa_decode_attention(q, k, v, ln, 32)
    assert swa.LAUNCHES["swa_decode"] == 1
    with pytest.raises(ValueError, match="head_dim"):
        swa.swa_decode(q[..., :48].contiguous(), k[..., :48].contiguous(),
                       v[..., :48].contiguous(), ln, 32)
    with pytest.raises(TypeError):
        swa.swa_decode(q, k.to(torch.bfloat16), v, ln, 32)
    with pytest.raises(TypeError):
        swa.swa_decode(q, k, v, ln.to(torch.int64), 32)
    assert swa.LAUNCHES["swa_decode"] == 1


def test_reduced_hybrid_decode_on_the_card_matches_cpu(cuda):
    """REDUCED recurrentgemma, f32, teacher-forced for 160 steps (the
    window of 64 slides): logits on the card within 1e-3 of the largest
    CPU logit, and one ``swa_decode`` launch per attention layer and step."""
    from repro_torch import configs
    from repro_torch.kernels import swa_attention as swa
    from repro_torch.models import api, layers, rglru
    cfg = configs.get("recurrentgemma-2b", reduced=True).replace(dtype=torch.float32)
    cpu_params = api.init_params(torch.Generator().manual_seed(0), cfg)
    gpu_params = layers.map_leaves(lambda t: t.to(cuda), cpu_params)
    b, steps = 2, 160
    caches = {"cpu": api.init_cache(cfg, b, steps + 1, device="cpu"),
              "cuda": api.init_cache(cfg, b, steps + 1, device=cuda)}
    step = api.make_serve_step(cfg)
    toks = torch.randint(0, cfg.vocab_size, (steps, b, 1),
                         generator=torch.Generator().manual_seed(1))
    swa.reset_launches()
    for t in range(steps):
        caches["cpu"], want = step(cpu_params, caches["cpu"], toks[t])
        caches["cuda"], got = step(gpu_params, caches["cuda"], toks[t].to(cuda))
        err = float(torch.max(torch.abs(got.cpu() - want)))
        assert err <= 1e-3 * float(torch.max(torch.abs(want))), (t, err)
    n_attn = rglru.pattern(cfg).count("attn")
    assert swa.LAUNCHES["swa_decode"] == n_attn * steps


def _outside_fog_case(device, bad=3, d=1352, seed=5):
    """Six clients in three fogs, client 3's id ``bad`` (outside the fogs)."""
    g = torch.Generator().manual_seed(seed)
    deltas = torch.randn((6, d), generator=g)
    err = 0.1 * torch.randn((6, d), generator=g)
    fog_id = torch.tensor([0, 1, 2, bad, 0, 1], dtype=torch.int32)
    weights = torch.tensor([48.0, 32.0, 16.0, 64.0, 48.0, 8.0])
    return [t.to(device) for t in (deltas, err, fog_id, weights)]


@pytest.mark.parametrize("bad", [3, -1])
def test_operators_drop_a_fog_id_outside_the_fogs_on_the_card(cuda, bad):
    """``aggregation.fog_aggregate``, ``ops.robust_aggregate`` and
    ``ops.compress_aggregate_wire`` on CUDA tensors with one client of no
    fog: they return, and equal their CPU routes (which drop it)."""
    deltas, err, fog_id, weights = _outside_fog_case(cuda, bad)
    cpu = [t.cpu() for t in (deltas, err, fog_id, weights)]
    got = agg.fog_aggregate(deltas, fog_id, weights, 3)
    want = agg.fog_aggregate(cpu[0], cpu[2], cpu[3], 3)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(), rtol=1e-5, atol=1e-6)
    assert torch.equal(got[1].cpu(), want[1]) and float(got[1].sum()) == 152.0
    before = ra.LAUNCHES["robust_agg"]
    out, fw = ops.robust_aggregate(deltas, fog_id, weights, 3, 0.2, "trimmed")
    torch.cuda.synchronize()
    assert ra.LAUNCHES["robust_agg"] == before + 1
    w_out, w_fw = ops.robust_aggregate(cpu[0], cpu[2], cpu[3], 3, 0.2, "trimmed")
    np.testing.assert_allclose(out.cpu().numpy(), w_out.numpy(), rtol=1e-5, atol=1e-6)
    assert torch.equal(fw.cpu(), w_fw)
    before = fa.LAUNCHES["wire_agg"]
    fog_sum, new_err = ops.compress_aggregate_wire(deltas, err, fog_id, weights, 3, 0.05)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["wire_agg"] == before + 1
    w_sum, w_err = ops.compress_aggregate_wire(*cpu, 3, 0.05)
    np.testing.assert_allclose(fog_sum.cpu().numpy(), w_sum.numpy(), rtol=1e-5, atol=1e-4)
    assert torch.equal(new_err.cpu(), w_err)
    fused, _ = ops.compress_aggregate(deltas, err, fog_id, weights, 3, 0.05)
    np.testing.assert_allclose(fused.cpu().numpy(), w_sum.numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("method,kw,kernels", [
    ("fedavg", dict(), {"local_train_f32": 3, "fused_agg": 6}),
    ("fedprox", dict(), {"local_train_f32": 3, "fused_agg": 6}),
    ("fedadam", dict(client_chunk=5), {"local_train_f32": 3, "wire_emit": 9, "wire_agg": 9}),
    ("fedavg", dict(robust="trimmed", trim_frac=0.3, faults=FaultConfig(
        byz_mode="gauss", byz_frac=0.25, byz_scale=20.0, erasure_prob=0.3)),
     {"local_train_f32": 3, "fused_agg": 6, "robust_agg": 3}),
    ("scaffold", dict(), {}),
    ("centralised", dict(), {}),
])
def test_flat_trials_on_the_card_match_the_cpu(cuda, method, kw, kernels):
    """Quick-size flat trials, identical draws on both devices; each
    launches the kernels of its path, and only those."""
    cfg = exp.make_config(n_sensors=12, n_fog=3, rounds=3, local_epochs=1, **kw)
    ds = normalize(generate(torch.Generator().manual_seed(0), SyntheticConfig(
        n_sensors=12, train_len=48, val_len=24, test_len=48), device="cpu"))
    inputs = exp.draw_trial(torch.Generator().manual_seed(1), ds, cfg, method=method)
    counts = (lt.LAUNCHES, fa.LAUNCHES, ra.LAUNCHES, q8.LAUNCHES, tk.LAUNCHES)
    before = {k: v for c in counts for k, v in c.items()}
    gpu = exp.trial_metrics(method, None, ds, cfg, inputs=inputs)
    torch.cuda.synchronize()
    after = {k: v for c in counts for k, v in c.items()}
    assert {k: after[k] - before[k] for k in after} == {k: kernels.get(k, 0) for k in after}
    cpu = exp.trial_metrics(method, None, ds, cfg, inputs=inputs, device="cpu")
    assert gpu["losses"].device.type == "cuda"
    for name in ("participation", "erased_total", "e_total", "e_s2f"):
        np.testing.assert_allclose(gpu[name].cpu().numpy(), cpu[name].numpy(), rtol=1e-5)
    np.testing.assert_allclose(gpu["losses"].cpu().numpy(), cpu["losses"].numpy(), rtol=1e-4)


@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")])
def test_client_mesh_on_the_card_matches_the_unsharded_round(cuda, tmp_path, world, backend):
    """``hfl.train`` and ``flat_fl.train_flat`` with a client mesh of
    spawned ranks on the card (``tests/torch_mesh_ranks.py``; at W = 2 both
    ranks share the card over gloo) at ``tests/test_torch_mesh.py``'s size,
    against the unsharded card run on the same draws: bitwise at W = 1;
    at W = 2 energies to rtol 1e-5, losses to rtol 1e-4, params to atol
    1e-5 and counters exactly.  Every rank holds the same bits and makes
    one unsharded trial's launches, on its half of the clients."""
    from torch_mesh_ranks import run_ranks

    from repro_torch.core import flat_fl, hfl

    cfg = exp.make_config(n_sensors=8, n_fog=3, rounds=2, local_epochs=1)
    ds = normalize(generate(torch.Generator().manual_seed(0), SyntheticConfig(
        n_sensors=8, train_len=48, val_len=24, test_len=48), device="cpu"))
    inputs = exp.draw_trial(torch.Generator().manual_seed(2), ds, cfg)
    families = {"hfl": hfl.train, "flat": flat_fl.train_flat}
    ds_dev = type(ds)(*(t.to(cuda) for t in ds))
    want = []      # first, so that the kernels are built before the ranks start
    for train in families.values():
        params, m = train(inputs.params, ae.loss, ds_dev, cfg, inputs.dep, inputs.draws)
        want.append((ae.ravel(params).cpu(), {k: v.cpu() for k, v in m._asdict().items()}))
    ranks = run_ranks([("train", f, cfg, ds, inputs) for f in families], world, tmp_path,
                      device="cuda", backend=backend, timeout_s=300.0)
    for i, (want_p, want_m) in enumerate(want):
        got = ranks[0][i]
        assert got["launches"]["local_train_f32"] == cfg.rounds
        assert got["launches"]["fused_agg"] == 2 * cfg.rounds
        assert got["clients"] == {"local_train_f32": [8 // world] * cfg.rounds,
                                  "fused_agg": [8 // world] * cfg.rounds}
        for other in ranks[1:]:
            assert torch.equal(other[i]["params"], got["params"])
            assert all(torch.equal(other[i]["metrics"][k], v) for k, v in got["metrics"].items())
        if world == 1:
            assert torch.equal(got["params"], want_p)
            assert all(torch.equal(got["metrics"][k], v) for k, v in want_m.items())
            continue
        np.testing.assert_allclose(got["params"].numpy(), want_p.numpy(), rtol=0, atol=1e-5)
        for k, v in want_m.items():
            if k == "loss":
                np.testing.assert_allclose(got["metrics"][k].numpy(), v.numpy(), rtol=1e-4)
            elif v.dtype.is_floating_point and k != "participation":
                np.testing.assert_allclose(got["metrics"][k].numpy(), v.numpy(), rtol=1e-5)
            else:
                assert torch.equal(got["metrics"][k], v), k


# --- language-model training and the pod family ----------------------------------

@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "llama3-8b", "gemma2-27b", "internvl2-26b"])
def test_lm_train_step_on_the_card_matches_cpu(cuda, arch):
    """One ``make_train_step`` at REDUCED f32 from the same weights and
    tokens: loss to rtol 1e-4, every leaf's update (new - old) within 1e-3
    of the largest update coordinate (lr 1e-2: at 3e-4 the f32 rounding of
    the new params is ~4e-4 of the update), and the prefill step's last
    hidden state within 1e-4 of its largest entry."""
    from repro_torch import configs
    from repro_torch.models import api, layers
    from repro_torch.optim import sgd
    cfg = configs.get(arch, reduced=True).replace(dtype=torch.float32, learning_rate=1e-2)
    cpu_params = api.init_params(torch.Generator().manual_seed(0), cfg)
    gpu_params = layers.map_leaves(lambda t: t.to(cuda), cpu_params)
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 48), generator=g)}
    if cfg.n_visual_tokens:
        batch["visual_embeds"] = torch.randn((2, cfg.n_visual_tokens, cfg.d_model), generator=g)
    gpu_batch = {k: v.to(cuda) for k, v in batch.items()}
    step = api.make_train_step(cfg)
    new_c, loss_c = step(cpu_params, batch)
    new_g, loss_g = step(gpu_params, gpu_batch)
    np.testing.assert_allclose(float(loss_g), float(loss_c), rtol=1e-4)
    upd = [(b - a, (d.cpu() - c.cpu())) for a, b, c, d in zip(
        *(sgd.tree_leaves(t) for t in (cpu_params, new_c, gpu_params, new_g)))]
    biggest = max(float(u.abs().max()) for u, _ in upd)
    for want, got in upd:
        assert float((got - want).abs().max()) <= 1e-3 * biggest
    want_h = api.make_prefill_step(cfg)(cpu_params, batch)
    got_h = api.make_prefill_step(cfg)(gpu_params, gpu_batch).cpu()
    assert float((got_h - want_h).abs().max()) <= 1e-4 * float(want_h.abs().max())


@pytest.mark.parametrize("mode", ["int8", "topk"])
def test_pod_step_on_the_card_matches_cpu(cuda, mode):
    """The 2-pod loop of ``core/mesh_fl`` at REDUCED f32, two steps, on the
    card and on the CPU: losses to rtol 1e-4, params to atol 1e-5 but
    where an int8 code rounds the other way (one quantisation step, at
    most 1e-3 of a leaf's coordinates or two)."""
    from repro_torch import configs
    from repro_torch.core import mesh_fl
    from repro_torch.models import api, layers
    from repro_torch.optim import sgd
    cfg = configs.get("llama3-8b", reduced=True).replace(dtype=torch.float32, learning_rate=1e-2)
    cpu_params = api.init_params(torch.Generator().manual_seed(0), cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 16),
                                     generator=torch.Generator().manual_seed(1))}
    out = {}
    for dev in ("cpu", cuda):
        params = layers.map_leaves(lambda t, dev=dev: t.to(dev), cpu_params)
        step = mesh_fl.make_pod_hfl_train_step(cfg, None, mode=mode, n_pods=2)
        err, losses = mesh_fl.init_err(params, 2), []
        for _ in range(2):
            params, err, loss = step(params, err, {k: v.to(dev) for k, v in batch.items()})
            losses.append(float(loss))
        out[str(dev)] = ([p.cpu() for p in sgd.tree_leaves(params)],
                         [e.cpu() for e in sgd.tree_leaves(err)], losses)
    (pc, ec, lc), (pg, eg, lg) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    for want, got, e in zip(pc, pg, ec):
        diff = (got - want).abs()
        far = diff > 1e-5
        step_size = 2 * float(e.abs().max()) * 1e-2 + 1e-5
        assert bool(torch.all(diff <= step_size))
        assert int(far.sum()) <= max(2, 1e-3 * want.numel())


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "llama3-8b"])
def test_data_parallel_step_on_the_card(cuda, tmp_path, arch):
    """``make_train_step(cfg, data=mesh)`` as 2 gloo ranks sharing the
    card (``tests/torch_mesh_ranks.py``), REDUCED f32 at lr 1e-2, each rank
    on its half of the batch: both ranks' new params the same bits, and
    against the one-process card step on the whole batch the loss to
    rtol 1e-5 and every update within 1e-4 of the largest update
    coordinate (the train-step rule)."""
    from torch_mesh_ranks import run_ranks

    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.optim import sgd
    cfg = configs.get(arch, reduced=True).replace(dtype=torch.float32, learning_rate=1e-2)
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 32), dtype=torch.int32,
                                     generator=torch.Generator().manual_seed(1))}
    gpu_params = sgd.tree_unflatten(params, [p.to(cuda) for p in sgd.tree_leaves(params)])
    new, loss = api.make_train_step(cfg)(gpu_params, {k: v.to(cuda) for k, v in batch.items()})
    ranks = run_ranks([("step", cfg, params, batch, 1)], 2, tmp_path, device="cuda",
                      backend="gloo", timeout_s=300.0)
    a, b = ranks[0][0], ranks[1][0]
    assert all(torch.equal(x, y) for x, y in zip(a["params"], b["params"]))
    np.testing.assert_allclose(float(a["losses"][0]), float(loss), rtol=1e-5)
    upd = [(n.cpu() - p, g - p) for p, n, g in zip(sgd.tree_leaves(params),
                                                    sgd.tree_leaves(new), a["params"])]
    biggest = max(float(w.abs().max()) for w, _ in upd)
    for want, got in upd:
        assert float((got - want).abs().max()) <= 1e-4 * biggest


def test_cooperative_mix_on_the_card_is_one_fma(cuda):
    """Eq. 15's mix on the card is fma(w_self, theta_m, w_partner
    theta_peer), bitwise an f64 product plus sum rounded once, as on the
    CPU."""
    from repro_torch.core.aggregation import cooperative_mix
    from repro_torch.core.cooperation import CoopDecision

    g = torch.Generator().manual_seed(0)
    fog = torch.randn((4, 3, 5000), generator=g)
    partner = torch.randint(0, 3, (4, 3), generator=g)
    ws = torch.rand((4, 3), generator=g)
    dec = CoopDecision(partner, ws, 1.0 - ws, partner != torch.arange(3), torch.zeros((4, 3)))
    got = cooperative_mix(fog.to(cuda), CoopDecision(*(t.to(cuda) for t in dec))).cpu()
    pp = (1.0 - ws)[..., None] * torch.take_along_dim(fog, partner[..., None], dim=-2)
    assert torch.equal(got, (ws[..., None].double() * fog.double() + pp.double()).float())


@pytest.mark.parametrize("lead", [(2,), (16,), (4, 2)])
def test_weighted_mean_on_the_card_is_each_trials_own(cuda, lead):
    """``aggregation.weighted_mean`` over folded trials on the card: each
    trial's mean bitwise the mean of its own (R, d) rows, whatever the
    trials beside it (fog models of train-200's shape, R = 20)."""
    from repro_torch.core.aggregation import weighted_mean

    g = torch.Generator().manual_seed(0)
    updates = torch.randn(lead + (20, 1352), generator=g).to(cuda)
    weights = torch.rand(lead + (20,), generator=g).to(cuda)
    got = weighted_mean(updates, weights)
    flat_u, flat_w = updates.reshape(-1, 20, 1352), weights.reshape(-1, 20)
    for i, row in enumerate(got.reshape(-1, 1352)):
        assert torch.equal(row, weighted_mean(flat_u[i], flat_w[i]))


def test_compress_on_the_card_at_a_long_row_matches_plain(cuda):
    """``ops.compress`` on one row of d = 2^24 + 17 (2,049 blocks, the last
    17 wide): codes through the (N, nb, 8192) view, recon, new_err and the
    payload bitwise the plain version's."""
    d = (1 << 24) + 17
    g = torch.Generator().manual_seed(0)
    delta = torch.randn((1, d), generator=g)
    err = torch.randn((1, d), generator=g) * 0.1
    want = ops.compress(delta, err, 0.05)
    before = q8.LAUNCHES["compress_q8"]
    got = ops.compress(delta.to(cuda), err.to(cuda), 0.05)
    assert q8.LAUNCHES["compress_q8"] == before + 1
    for w, x in zip(want, got):
        assert torch.equal(x.cpu(), w)


LONG_D = 2 ** 31 + 8209       # 262,145 full blocks (one starts at 2^31), then 17 columns


def test_compressors_on_the_card_take_a_row_past_two_to_the_31(cuda):
    """``compress_q8``, ``quant8`` and ``topk_ef`` on one real row of 2^31 +
    8,209 coordinates (d and a block's start as 64-bit on the card): the
    first block, blocks 262,143 and 262,144 on either side of 2^31, and
    the 17-wide last block bitwise the plain versions run on the same
    blocks.  Each kernel's outputs are freed before the next (topk_ef's
    row takes ~35 GB with its inputs)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    delta = torch.randn((1, LONG_D), generator=g, device=cuda)
    err = torch.randn((1, LONG_D), generator=g, device=cuda).mul_(0.1)
    blk, nb = ops.BLOCK_ELEMS, -(-LONG_D // ops.BLOCK_ELEMS)
    assert (nb - 2) * blk == 2 ** 31 and LONG_D - (nb - 1) * blk == 17
    k = ops.block_k(comp.blockwise_k_frac(LONG_D, 0.05))
    spans = [(b, min(LONG_D, (b + 1) * blk)) for b in (0, nb - 3, nb - 2, nb - 1)]

    def cols(b, end):
        return slice(b * blk, end)

    q, scale, new_err = q8.compress_blocks(delta, err, k)
    for b, end in spans:
        wq, ws, we = ref.compress_ref(delta[:, cols(b, end)].contiguous(),
                                      err[:, cols(b, end)].contiguous(), k)
        assert torch.equal(q[:, cols(b, end)], wq) and torch.equal(new_err[:, cols(b, end)], we)
        assert torch.equal(scale[:, b:b + 1], ws), b
    del q, scale, new_err
    q, scale = q8.quant8_blocks(delta)
    assert q.shape == (1, nb * blk)
    for b, end in spans:
        wq, ws = ref.quant8_ref(delta[:, cols(b, end)].contiguous())
        assert torch.equal(q[:, b * blk:(b + 1) * blk], wq) and torch.equal(scale[:, b:b + 1], ws)
    del q, scale
    sparse, new_err = tk.topk_ef_blocks(delta, err, k)
    for b, end in spans:
        ws, we = ref.blockwise_topk_ef_ref(delta[:, cols(b, end)].contiguous(),
                                           err[:, cols(b, end)].contiguous(), k)
        assert torch.equal(sparse[:, cols(b, end)], ws)
        assert torch.equal(new_err[:, cols(b, end)], we)


# --- the moe, ssm and encdec families, and qwen3 ------------------------------------

NEW_LM_ARCHS = ["qwen3-14b", "qwen3-32b", "qwen2-moe-a2.7b", "grok-1-314b", "mamba2-2.7b",
                "whisper-medium"]


def _lm_batch(cfg, b, s, seed):
    g = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g)}
    if cfg.family == "encdec":
        batch["audio_embeds"] = torch.randn((b, cfg.n_audio_frames, cfg.d_model), generator=g)
    return batch


@pytest.mark.parametrize("arch", NEW_LM_ARCHS)
def test_new_lm_families_on_the_card_match_cpu(cuda, arch):
    """REDUCED f32 from the same weights and inputs on the card and on the
    CPU: one train step (loss to rtol 1e-4, every update within 1e-3 of
    the largest update coordinate at lr 1e-2), the prefill step (1e-4 of
    its largest), and 32 teacher-forced decode steps (logits within 1e-3
    of the largest CPU logit; whisper from ``precompute_cross_kv``), with
    one ``swa_decode`` launch per self-attention layer and step (none for
    mamba2)."""
    from repro_torch import configs
    from repro_torch.kernels import swa_attention as swa
    from repro_torch.models import api, layers
    from repro_torch.optim import sgd
    cfg = configs.get(arch, reduced=True).replace(dtype=torch.float32, learning_rate=1e-2)
    cpu_params = api.init_params(torch.Generator().manual_seed(0), cfg)
    gpu_params = layers.map_leaves(lambda t: t.to(cuda), cpu_params)
    batch = _lm_batch(cfg, 2, 32, 1)
    gpu_batch = {k: v.to(cuda) for k, v in batch.items()}
    step = api.make_train_step(cfg)
    new_c, loss_c = step(cpu_params, batch)
    new_g, loss_g = step(gpu_params, gpu_batch)
    np.testing.assert_allclose(float(loss_g), float(loss_c), rtol=1e-4)
    upd = [(b - a, (d.cpu() - c.cpu())) for a, b, c, d in zip(
        *(sgd.tree_leaves(t) for t in (cpu_params, new_c, gpu_params, new_g)))]
    biggest = max(float(u.abs().max()) for u, _ in upd)
    for want, got in upd:
        assert float((got - want).abs().max()) <= 1e-3 * biggest
    want_h = api.make_prefill_step(cfg)(cpu_params, batch)
    got_h = api.make_prefill_step(cfg)(gpu_params, gpu_batch).cpu()
    assert float((got_h - want_h).abs().max()) <= 1e-4 * float(want_h.abs().max())

    steps, mod = 32, api.module(cfg)
    caches = {"cpu": api.init_cache(cfg, 2, steps + 1, device="cpu"),
              "cuda": api.init_cache(cfg, 2, steps + 1, device=cuda)}
    if cfg.family == "encdec":
        for dev, params, b in (("cpu", cpu_params, batch), ("cuda", gpu_params, gpu_batch)):
            with torch.no_grad():
                ck, cv = mod.precompute_cross_kv(params, mod.encode(params, b["audio_embeds"],
                                                                     cfg), cfg)
            caches[dev] = caches[dev]._replace(cross_k=ck, cross_v=cv)
    serve = api.make_serve_step(cfg)
    swa.reset_launches()
    for t in range(steps):
        tok = batch["tokens"][:, t:t + 1]
        caches["cpu"], want = serve(cpu_params, caches["cpu"], tok)
        caches["cuda"], got = serve(gpu_params, caches["cuda"], tok.to(cuda))
        err = float(torch.max(torch.abs(got.cpu() - want)))
        assert err <= 1e-3 * float(torch.max(torch.abs(want))), (t, err)
    n_attn = 0 if cfg.family == "ssm" else cfg.n_layers
    assert swa.LAUNCHES["swa_decode"] == n_attn * steps


EXAMPLE_RUNS = {   # example -> (argv at a small size, the kernels its path launches)
    "quickstart": ([], ("local_train_f32", "fused_agg")),
    "train_iout_hfl": (["--rounds", "2", "--local-epochs", "1"],
                       ("local_train_f32", "fused_agg")),
    "serve_anomaly": (["--rounds", "4", "--n-sensors", "8", "--train-len", "48",
                       "--batch-rows", "256"], ("local_train_f32", "fused_agg", "fused_score_f32")),
    "load_replay": (["--duration", "1", "--int8"], ("fused_score_f32", "fused_score_q8")),
}


@pytest.mark.parametrize("name", list(EXAMPLE_RUNS))
def test_examples_on_the_card_launch_their_kernels(cuda, tmp_path, name):
    """Each example of ``repro_torch.examples`` on the card at a small
    size: its fields, and every kernel of its path launched."""
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    argv, kernels = EXAMPLE_RUNS[name]
    if name in ("train_iout_hfl", "serve_anomaly"):
        argv = argv + ["--ckpt-dir", str(tmp_path)]
    counters = {"local_train_f32": lt.LAUNCHES, "fused_agg": fa.LAUNCHES,
                "fused_score_f32": fs.LAUNCHES, "fused_score_q8": fs.LAUNCHES}
    for reset in (lt.reset_launches, fa.reset_launches, fs.reset_launches):
        reset()
    out = mod.main(argv, device=cuda)
    for k in kernels:
        assert counters[k][k] > 0, k
    if name == "serve_anomaly":
        assert out["service"]["swaps"] >= 1 and out["swapped"] is True
        assert 0.0 <= out["f1"] <= 1.0 and out["mean_abs_error_shift"] > 0.0
    elif name == "load_replay":
        assert out["fixed"]["e2e_p99_ms"] > 0 and "adaptive_bucketed_int8" in out
    elif name == "quickstart":
        assert all(0.0 <= r.f1 <= 1.0 for r in out.values())
    else:
        assert len(out["rounds"]) == 2 and 0.0 <= out["f1"] <= 1.0


def test_adam_on_the_card_matches_cpu(cuda):
    """Three ``sgd.adam`` steps on the card and on the CPU from the same f32
    tree and gradients: every leaf within 1e-6 of its largest magnitude."""
    from repro_torch.optim import sgd
    g = torch.Generator().manual_seed(3)
    cpu = ae.init(g, 32, (16, 8, 16), device="cpu")
    grads = [ae.init(g, 32, (16, 8, 16), device="cpu") for _ in range(3)]
    gpu = [{k: v.to(cuda) for k, v in layer.items()} for layer in cpu]
    sc, sg = sgd.adam_init(cpu), sgd.adam_init(gpu)
    for gr in grads:
        cpu, sc = sgd.adam(cpu, gr, sc, 1e-2, weight_decay=0.01)
        gpu, sg = sgd.adam(gpu, [{k: v.to(cuda) for k, v in layer.items()} for layer in gr], sg,
                           1e-2, weight_decay=0.01)
    assert int(sg.count) == 3
    for a, b in zip(sgd.tree_leaves(cpu), sgd.tree_leaves(gpu)):
        assert float((b.cpu() - a).abs().max()) <= 1e-6 * float(a.abs().max())


def test_dryrun_param_bytes_equal_an_allocated_model(cuda):
    """The dry run's parameter bytes (nothing allocated) against llama3-8b
    at full width cut to 2 layers allocated on the card."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api, layers
    cfg = configs.get("llama3-8b").replace(n_layers=2)
    shape = ShapeConfig("card-train", 128, 2, "train")
    rec = dryrun.dryrun_one("llama3-8b", shape.name, cfg=cfg, shape=shape, mesh=make_host_mesh())
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    params = api.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    held = sum(t.numel() * t.element_size() for t in layers.leaves(params))
    assert rec["param_bytes"] == held
    assert torch.cuda.memory_allocated() - before >= held
    del params

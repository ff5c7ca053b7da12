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
also at rows 1 to 65,537 at four depths, and a row's err bitwise equal
in any batch.
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
    with pytest.raises(ValueError, match="shared memory"):
        fs.score_rows(
            torch.zeros((8, 512), device=cuda), torch.zeros(8, device=cuda),
            tuple(p["w"] for p in big), tuple(p["b"] for p in big),
        )


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


def _recon_case(n, d, layout, device, seed=0):
    """Real compressed reconstructions (blockwise rho_s 0.05 int8 through
    the fused_agg kernel): most members tie at exactly 0 in most columns.
    Integer round weights, a quarter of them 0."""
    g = torch.Generator().manual_seed(seed)
    deltas = torch.randn((n, d), generator=g).to(device)
    err = (0.1 * torch.randn((n, d), generator=g)).to(device)
    recon, _ = agg.client_compress(deltas, err, comp.CompressorConfig())
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
    return recon, fog_id.to(device), weights.to(device)


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
    identity segments (one fog per client, as the robust path compresses)
    and ``robust_agg`` with three populated fogs, two of them past the
    grid's rows, each against its plain version."""
    n, d = 66_000, 64
    deltas, err, _, weights = _agg_case(n, d, 3, cuda, seed=11)
    ids = torch.arange(n, dtype=torch.int32, device=cuda)
    fog_sum, new_err, _ = fa.compress_aggregate_blocks(deltas, err, ids, weights, n, 3)
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


def test_fleet_shapes_match_plain(cuda):
    """The kernels at fleet-10k's shapes (N = 10,000, d = 1,352, 1,000
    fogs, k = 68, int8): ``fused_agg`` unchunked, and the wire pair chunk
    by chunk (512 clients) into running fog sums, each against its plain
    version."""
    n, d, n_fog, chunk = 10_000, 1352, 1000, 512
    deltas, err, fog_id, weights = _agg_case(n, d, n_fog, cuda, seed=10)
    k = ops.wire_k(comp.blockwise_k_frac(d, 0.05))
    fog_sum, new_err, thr = fa.compress_aggregate_blocks(deltas, err, fog_id, weights, n_fog, k)
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
    """The two selections (team_threshold and block_threshold) on the same
    rows: wire_emit's new_err equals compress_q8's bit for bit."""
    for d in (1352, 8209):
        deltas, err = _wire_rows(200, d, 68, cuda, seed=d + 1)
        _, _, _, wire_err = fa.compress_wire_blocks(deltas, err, 68)
        _, _, q8_err = q8.compress_blocks(deltas, err, 68)
        assert torch.equal(wire_err, q8_err)


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

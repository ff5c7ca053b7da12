"""The CUDA kernels against their plain versions, on the Hopper card.

Every test here takes the ``cuda`` fixture, which skips when there is no
sm_90 card; whether there is one is decided inside the fixture, never at
import, so every pytest worker collects the same tests.  On the card:
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest``: ``tests/conftest.py`` imports JAX, which the card's
machine does not have).

Tolerance: score errors to ``rtol=1e-5, atol=1e-5`` (the kernel sums in
another order than PyTorch's matmul); flags exactly, except on rows within
``1e-5 * max(1, |tau|)`` of tau.  Training kernels: local-train deltas to
``rtol=1e-4, atol=1e-6`` and losses to ``rtol=1e-5``; compress-aggregate
survivor sets exactly, new_err to ``atol=1e-5`` and fog sums to
``rtol=1e-5, atol=1e-4`` (the reference's kernel-vs-oracle tolerances).
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.data.pipeline import multi_epoch_indices
from repro_torch.data.synthetic import SyntheticConfig, generate, normalize
from repro_torch.kernels import fused_agg as fa
from repro_torch.kernels import fused_score as fs
from repro_torch.kernels import local_train as lt
from repro_torch.kernels import ops, ref
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


@pytest.mark.parametrize("weight_dtype", ["f32", "int8"])
def test_service_on_the_card_matches_cpu_service(cuda, tmp_path, weight_dtype):
    store = CheckpointStore(str(tmp_path))
    params = ae.init(torch.Generator().manual_seed(2), device="cpu")
    store.publish(1, params)
    rng = np.random.default_rng(0)
    reqs = [rng.standard_normal((n, 32)).astype(np.float32) for n in (10, 200, 1500, 64)]
    out = []
    for device in (None, "cpu"):
        svc = ScoringService(store, params, buckets=(128, 1024), tau=30.0,
                             weight_dtype=weight_dtype, device=device)
        rids = [svc.submit(r, fog=None) for r in reqs]
        res = svc.drain()
        out.append([res[r] for r in rids])
        assert svc.device.type == ("cuda" if device is None else "cpu")
    for a, b in zip(*out):
        np.testing.assert_allclose(a.error, b.error, rtol=1e-5, atol=1e-5)
        near = np.abs(b.error - 30.0) <= 30.0 * 1e-5
        np.testing.assert_array_equal(a.flag[~near], b.flag[~near])


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

"""The CUDA kernels against their plain versions, on the Hopper card.

Every test here takes the ``cuda`` fixture, which skips when there is no
sm_90 card; whether there is one is decided inside the fixture, never at
import, so every pytest worker collects the same tests.  On the card:
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest``: ``tests/conftest.py`` imports JAX, which the card's
machine does not have).

Tolerance: errors to ``rtol=1e-5, atol=1e-5`` (the kernel sums in another
order than PyTorch's matmul); flags exactly, except on rows within
``1e-5 * max(1, |tau|)`` of tau.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.kernels import fused_score as fs
from repro_torch.kernels import ops, ref
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

"""Port parity for the Byzantine-robust fog reduce, PyTorch vs JAX.

``repro_torch.kernels.ops.robust_aggregate`` on CPU tensors (the plain
version ``kernels/ref.robust_aggregate_ref`` that the CUDA kernel
``robust_agg`` is held against on the card) against
``repro.kernels.ops.robust_aggregate(use_pallas=False)``, the reference's
jnp oracle (its Pallas interpret run cannot trace under the installed jax:
``pl.load`` is gone).

Grid: trimmed at beta 0 / 0.2 / 0.45 and the median; uneven fogs (one
holding half the clients) and an empty fog; integer round weights
(``n_samples * delivered``) and fractional ones; Gaussian values and real
compressed reconstructions (blockwise Top-K at rho_s 0.05 + int8, where
most members tie at exactly 0 in almost every coordinate); d = 1,352 and
8,209.  Outputs to ``rtol=1e-5, atol=1e-6`` (``tests/test_faults.py``'s
kernel-vs-oracle tolerance); fog weights exactly when they are integers,
to ``rtol=1e-6`` (the same file's) when fractional, since the two
packages sum them in another order.  Also the reference's
own contracts: trim 0 is the weighted mean, small median cases, outliers
rejected.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import one_intra_op_thread  # noqa: F401

from repro.kernels import ops as jops
from repro_torch.core import aggregation as tagg
from repro_torch.core import compression as tcomp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

N, N_FOG = 24, 5
TOL = dict(rtol=1e-5, atol=1e-6)
MODES = [("trimmed", 0.0), ("trimmed", 0.2), ("trimmed", 0.45), ("median", 0.0)]


def _case(d, values, weights, seed):
    rng = np.random.default_rng(seed)
    fog_id = np.concatenate([np.zeros(12), rng.integers(1, 4, N - 12)]).astype(np.int32)
    rng.shuffle(fog_id)                      # fog 0 holds half, fog 4 is empty
    if weights == "integer":
        w = (48.0 * (rng.random(N) > 0.25)).astype(np.float32)
    else:
        w = rng.uniform(0.5, 1.5, N).astype(np.float32)
        w[::5] = 0.0
    x = rng.standard_normal((N, d)).astype(np.float32)
    if values == "compressed":
        err = (0.1 * rng.standard_normal((N, d))).astype(np.float32)
        recon, _ = tagg.client_compress(torch.from_numpy(x), torch.from_numpy(err),
                                        tcomp.CompressorConfig())
        x = recon.numpy()
        assert (x == 0).mean() > 0.9          # ties at 0 dominate
    return x, fog_id, w


def _both(x, fog_id, w, beta, mode, n_fog=N_FOG):
    got = tops.robust_aggregate(torch.from_numpy(x), torch.from_numpy(fog_id),
                                torch.from_numpy(w), n_fog, beta, mode)
    want = jops.robust_aggregate(jnp.asarray(x), jnp.asarray(fog_id), jnp.asarray(w), n_fog,
                                 beta, mode, use_pallas=False)
    return [t.numpy() for t in got], [np.asarray(t) for t in want]


@pytest.mark.parametrize("values", ["gauss", "compressed"])
@pytest.mark.parametrize("weights", ["integer", "fractional"])
@pytest.mark.parametrize("d", [1352, 8209])
def test_robust_aggregate_matches_jax(d, weights, values):
    x, fog_id, w = _case(d, values, weights, seed=d)
    for mode, beta in MODES:
        (out, fw), (out_j, fw_j) = _both(x, fog_id, w, beta, mode)
        np.testing.assert_allclose(out, out_j, **TOL, err_msg=f"{mode} {beta}")
        if weights == "integer":
            np.testing.assert_array_equal(fw, fw_j)
        np.testing.assert_allclose(fw, fw_j, rtol=1e-6)
        assert not out[4].any() and fw[4] == 0.0


def test_trim_is_clamped_and_modes_checked():
    x, fog_id, w = _case(40, "gauss", "integer", 1)
    (out, _), (out_j, _) = _both(x, fog_id, w, 0.7, "trimmed")
    np.testing.assert_allclose(out, out_j, **TOL)
    np.testing.assert_allclose(out, _both(x, fog_id, w, 0.4995, "trimmed")[0][0], **TOL)
    with pytest.raises(ValueError, match="mode"):
        tops.robust_aggregate(torch.from_numpy(x), torch.from_numpy(fog_id),
                              torch.from_numpy(w), N_FOG, 0.2, "krum")


def test_trim0_equals_weighted_mean():
    x, fog_id, w = _case(40, "gauss", "fractional", 2)
    w = w + 0.5
    out, fw = tops.robust_aggregate(torch.from_numpy(x), torch.from_numpy(fog_id),
                                    torch.from_numpy(w), N_FOG, 0.0, "trimmed")
    w_fog = np.where(fog_id[None, :] == np.arange(N_FOG)[:, None], w[None, :], 0.0)
    ref = (w_fog @ x) / np.maximum(w_fog.sum(-1), 1e-12)[:, None]
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(fw.numpy(), w_fog.sum(-1), rtol=1e-6)


def test_weighted_median_small_cases():
    v = torch.tensor([[1.0], [5.0], [9.0]])
    fid = torch.zeros((3,), dtype=torch.int32)
    out, _ = tops.robust_aggregate(v, fid, torch.tensor([1.0, 1.0, 1.0]), 1, 0.0, "median")
    assert float(out[0, 0]) == 5.0
    out, _ = tops.robust_aggregate(v, fid, torch.tensor([10.0, 1.0, 1.0]), 1, 0.0, "median")
    assert float(out[0, 0]) == 1.0
    # Two tied members share the median group with weight 2 of 4: the lower
    # median is the tie group reaching W/2.
    v = torch.tensor([[3.0], [3.0], [7.0], [9.0]])
    out, _ = tops.robust_aggregate(v, torch.zeros((4,), dtype=torch.int32),
                                   torch.ones(4), 1, 0.0, "median")
    assert float(out[0, 0]) == 3.0


def test_outliers_rejected_mean_does_not():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((12, 40)).astype(np.float32)
    fog_id = (np.arange(12) % 3).astype(np.int32)
    x[0], x[1] = 1e4, -1e4
    args = (torch.from_numpy(x), torch.from_numpy(fog_id), torch.ones(12), 3)
    mean_out, _ = tops.robust_aggregate(*args, 0.0, "trimmed")
    trim_out, _ = tops.robust_aggregate(*args, 0.3, "trimmed")
    med_out, _ = tops.robust_aggregate(*args, 0.0, "median")
    assert float(mean_out.abs().max()) > 100.0
    assert float(trim_out.abs().max()) < 10.0
    assert float(med_out.abs().max()) < 10.0


def test_plain_version_chunks_columns_alike():
    """The plain version's coordinate chunking (a pair budget) changes
    only the summation order of num and den."""
    x, fog_id, w = _case(300, "compressed", "integer", 4)
    args = (torch.from_numpy(x), torch.from_numpy(fog_id), torch.from_numpy(w), N_FOG, 0.2)
    whole = tref.robust_aggregate_ref(*args)
    budget = tref.ROBUST_PAIR_BUDGET
    try:
        tref.ROBUST_PAIR_BUDGET = 12 * 12 * 7         # 7 columns per chunk in fog 0
        chunked = tref.robust_aggregate_ref(*args)
    finally:
        tref.ROBUST_PAIR_BUDGET = budget
    np.testing.assert_allclose(chunked[0].numpy(), whole[0].numpy(), **TOL)
    assert torch.equal(chunked[1], whole[1])


def test_member_lists_hold_each_fogs_clients_in_index_order():
    """The compacted member lists the CUDA robust wrapper hands its kernel
    (``kernels/robust_agg.member_lists``): fog m's clients of weight > 0
    are members[offsets[m]:offsets[m + 1]] in index order; empty fogs and
    ids outside [0, n_fog) belong to no fog, and the clients of no fog
    follow offsets[n_fog] in index order (the layout the card's list
    kernel writes)."""
    from repro_torch.kernels import robust_agg

    rng = np.random.default_rng(5)
    n, n_fog = 500, 7
    fog_id = rng.integers(-1, n_fog + 1, n).astype(np.int32)
    fog_id[fog_id == 3] = 2                                    # fog 3 stays empty
    w = (rng.random(n) > 0.3) * rng.integers(1, 5, n).astype(np.float32)
    members, offsets = robust_agg.member_lists(torch.from_numpy(fog_id), torch.from_numpy(w),
                                               n_fog)
    assert members.dtype == offsets.dtype == torch.int32 and offsets.shape == (n_fog + 1,)
    members, offsets = members.numpy(), offsets.numpy()
    for m in range(n_fog):
        want = np.flatnonzero((fog_id == m) & (w > 0))
        np.testing.assert_array_equal(members[offsets[m]:offsets[m + 1]], want)
    member = (fog_id >= 0) & (fog_id < n_fog) & (w > 0)
    np.testing.assert_array_equal(members[offsets[n_fog]:], np.flatnonzero(~member))


def _outside_case(d, seed):
    """Six clients in three fogs, the fourth client's id ``n_fog``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((6, d)).astype(np.float32)
    fog_id = np.array([0, 1, 2, 3, 0, 1], np.int32)
    w = np.array([48.0, 32.0, 16.0, 64.0, 48.0, 8.0], np.float32)
    return x, fog_id, w


@pytest.mark.parametrize("mode,beta", MODES)
def test_robust_aggregate_drops_a_fog_id_of_n_fog_as_the_reference_does(mode, beta):
    """A client whose fog id is ``n_fog`` belongs to no fog: both packages
    skip it (its weight too), and the result is that of the other five."""
    x, fog_id, w = _outside_case(1352, 3)
    (out, fw), (out_j, fw_j) = _both(x, fog_id, w, beta, mode, n_fog=3)
    np.testing.assert_allclose(out, out_j, **TOL)
    np.testing.assert_array_equal(fw, fw_j)
    keep = fog_id < 3
    (out_k, fw_k), _ = _both(x[keep], fog_id[keep], w[keep], beta, mode, n_fog=3)
    np.testing.assert_array_equal(out, out_k)
    np.testing.assert_array_equal(fw, fw_k)


def test_fog_aggregate_drops_a_fog_id_of_n_fog_as_the_reference_does():
    from repro.core import aggregation as jagg
    x, fog_id, w = _outside_case(40, 4)
    got, got_w = tagg.fog_aggregate(torch.from_numpy(x), torch.from_numpy(fog_id),
                                    torch.from_numpy(w), 3)
    want, want_w = jagg.fog_aggregate(jnp.asarray(x), jnp.asarray(fog_id), jnp.asarray(w), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(got_w.numpy(), [96.0, 40.0, 16.0])


@pytest.mark.parametrize("bad", [3, 7, -1])
def test_segment_sum_drops_ids_outside_the_fogs(bad):
    x = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    fog_id = torch.tensor([0, 1, 2, bad, 0, 1], dtype=torch.int32)
    out = tref.segment_sum(x, fog_id, 3)
    assert out.shape == (3, 2)
    np.testing.assert_array_equal(out.numpy(), [[8.0, 10.0], [12.0, 14.0], [4.0, 5.0]])

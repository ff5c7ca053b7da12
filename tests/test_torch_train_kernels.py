"""Port parity for the training slice's two kernel operators, PyTorch vs JAX.

The same numpy-seeded inputs go through ``repro.kernels.ops`` and through
``repro_torch.kernels.ops`` on the CPU (the plain versions that the CUDA
kernels ``fused_agg`` and ``local_train_f32`` are held against on the card).

- ``compress_aggregate``: fog sums to ``rtol=1e-5, atol=1e-4`` and new_err
  to ``atol=1e-5`` (the reference's own kernel-vs-oracle tolerances,
  ``tests/test_fused_agg.py``); the bisection thresholds and survivor masks
  exactly.  The reference's Pallas interpret run of ``_fused_agg_kernel``
  cannot trace under the installed jax (``pl.load`` is gone), so its jnp
  oracle is the only reference here.
- ``local_train``: deltas to ``rtol=1e-4, atol=1e-6`` and losses to
  ``rtol=1e-5`` against both the reference's jnp oracle and its Pallas
  kernel in interpret mode (``tests/test_fused_local_train.py``).
- The kernel's shared-memory ``layout()``, a pure function of the widths
  and the batch: its size, and every buffer 16-byte aligned, disjoint and
  inside the block's shared memory.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from torch_parity import one_intra_op_thread  # noqa: F401

from repro.data.pipeline import multi_epoch_indices as jax_indices
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import autoencoder as jae
from repro_torch.kernels import fused_agg as tfa
from repro_torch.kernels import local_train as tlt
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import autoencoder as tae

N_FOG = 4


def _agg_inputs(n, d, seed, empty_fog=None):
    rng = np.random.default_rng(seed)
    deltas = rng.standard_normal((n, d)).astype(np.float32)
    err = (0.1 * rng.standard_normal((n, d))).astype(np.float32)
    fog_id = rng.integers(0, N_FOG, n).astype(np.int32)
    if empty_fog is not None:
        fog_id[fog_id == empty_fog] = (empty_fog + 1) % N_FOG
    weights = np.abs(rng.standard_normal(n)).astype(np.float32)
    weights[::3] = 0.0                        # zero-weight non-participants
    return deltas, err, fog_id, weights


def _survivors(bisect, pad, v, k):
    """|v| > t per block, with t from ``bisect`` on the padded blocks."""
    absv = np.abs(pad(v))
    t = np.asarray(bisect(absv, k))
    return absv > t


def _jax_pad(v):
    n, d = v.shape
    nb = -(-d // jops.BLOCK_ELEMS)
    out = np.zeros((n, nb * jops.BLOCK_ELEMS), np.float32)
    out[:, :d] = v
    return out.reshape(n, nb, jops.BLOCK_ELEMS)


@pytest.mark.parametrize("k", [1, 68, 819])
@pytest.mark.parametrize("shape", [(3, 2, 8192), (5, 1, 8192)])
def test_bisect_threshold_equals_jax(shape, k):
    rng = np.random.default_rng(k + shape[0])
    absx = np.abs(rng.standard_normal(shape)).astype(np.float32)
    absx[0, 0, 100:] = 0.0                          # a block that is mostly padding
    want = np.asarray(jref.bisect_threshold(jnp.asarray(absx), k))
    got = tref.bisect_threshold(torch.from_numpy(absx), k).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("d", [1352, 8209, 65536])
def test_compress_aggregate_matches_jax(d, quantize):
    deltas, err, fog_id, weights = _agg_inputs(7, d, seed=d, empty_fog=2)
    fs_j, ne_j = jops.compress_aggregate(
        deltas, err, fog_id, weights, N_FOG, 0.05, quantize=quantize, use_pallas=False
    )
    fs_t, ne_t = tops.compress_aggregate(
        *(torch.from_numpy(a) for a in (deltas, err, fog_id, weights)), N_FOG, 0.05,
        quantize=quantize,
    )
    np.testing.assert_allclose(fs_t.numpy(), np.asarray(fs_j), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ne_t.numpy(), np.asarray(ne_j), atol=1e-5)
    np.testing.assert_array_equal(fs_t.numpy()[2], 0.0)              # the empty fog
    k = tops.block_k(0.05)
    v = deltas + err
    mask_j = _survivors(lambda a, kk: jref.bisect_threshold(jnp.asarray(a), kk), _jax_pad, v, k)
    mask_t = _survivors(
        lambda a, kk: tref.bisect_threshold(torch.from_numpy(a), kk),
        lambda x: tref.pad_blocks(torch.from_numpy(x)).numpy(), v, k,
    )
    np.testing.assert_array_equal(mask_t, mask_j)
    assert mask_t.sum(-1).max() <= k


def test_compress_aggregate_keeps_one_survivor_at_k_1():
    deltas, err, fog_id, weights = _agg_inputs(5, 1352, seed=3)
    k_frac = 1e-6                                    # rounds to k = 1
    assert tops.block_k(k_frac) == 1
    fs_j, ne_j = jops.compress_aggregate(
        deltas, err, fog_id, weights, N_FOG, k_frac, use_pallas=False
    )
    fs_t, ne_t = tops.compress_aggregate(
        *(torch.from_numpy(a) for a in (deltas, err, fog_id, weights)), N_FOG, k_frac
    )
    np.testing.assert_allclose(fs_t.numpy(), np.asarray(fs_j), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ne_t.numpy(), np.asarray(ne_j), atol=1e-5)
    # One coordinate per client left the error buffer: the largest |v|.
    moved = (ne_t.numpy() != deltas + err).sum(-1)
    np.testing.assert_array_equal(moved, 1)


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("d", [1352, 8209])
def test_dense_fold_is_the_fused_sum_in_client_order(d, quantize):
    """``ref.dense_fold_ref``, the client-order fold that ``fused_agg``'s
    sum launch is held to bitwise on the card, against the plain
    ``compress_aggregate_ref`` and the JAX oracle
    ``repro.kernels.ref.compress_aggregate_ref`` (``rtol=1e-5, atol=1e-4``:
    those sum in another order).  Repeated fogs, an empty fog (2), zero
    weights, and ids outside [0, n_fog), which belong to no fog."""
    deltas, err, fog_id, weights = _agg_inputs(40, d, seed=d + 1, empty_fog=2)
    fog_id[5], fog_id[17] = -1, N_FOG                       # in no fog
    args = tuple(torch.from_numpy(a) for a in (deltas, err, fog_id, weights))
    k = tops.block_k(0.05)
    fold = tref.dense_fold_ref(*args, N_FOG, k, quantize).numpy()
    plain, _, _ = tref.compress_aggregate_ref(*args, N_FOG, k, quantize)
    np.testing.assert_allclose(fold, plain.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(fold[2], 0.0)
    pad = _jax_pad
    want, _ = jref.compress_aggregate_ref(jnp.asarray(pad(deltas)), jnp.asarray(pad(err)),
                                          jnp.asarray(fog_id), jnp.asarray(weights), N_FOG, k,
                                          quantize)
    want = np.asarray(want).reshape(N_FOG, -1)[:, :d]
    np.testing.assert_allclose(fold, want, rtol=1e-5, atol=1e-4)
    rows = (fog_id >= 0) & (fog_id < N_FOG)                  # the fold by hand, client by client
    _, recon, _ = tref._dense_recon(args[0], args[1], k, quantize)
    recon = recon.reshape(40, -1)[:, :d].numpy()
    by_hand = np.zeros((N_FOG, d), np.float32)
    for i in np.flatnonzero(rows):
        by_hand[fog_id[i]] = by_hand[fog_id[i]] + weights[i] * recon[i]
    assert np.array_equal(fold, by_hand)


def test_int8_scale_is_the_reference_oracles_product():
    """The reference's jitted oracle computes the int8 scale ``amax / 127``
    as ``amax * f32(1/127)`` (XLA folds the division by a constant); the
    port does the same, so that a block whose true quotient and product
    differ by an ulp still gets the reference's int8 code.  Here the
    second survivor's code is 81 with the product and 80 with a true
    division, one step (0.0135) apart; the reference's CPU build contracts
    ``v - q * scale`` into an FMA, which moves new_err by ~1e-7 only."""
    amax, x = np.float32(1.7181083), np.float32(1.0890372)
    assert np.float32(np.float64(amax) / 127.0) != amax * np.float32(1.0 / 127.0)
    deltas = np.zeros((1, 1352), np.float32)
    deltas[0, :2] = amax, x
    deltas[0, 2:] = np.linspace(-1e-3, 1e-3, 1350, dtype=np.float32)
    err = np.zeros_like(deltas)
    args = (np.zeros(1, np.int32), np.ones(1, np.float32), 1, 0.05)
    _, ne_j = jops.compress_aggregate(deltas, err, *args, use_pallas=False)
    _, ne_t = tops.compress_aggregate(torch.from_numpy(deltas), torch.from_numpy(err),
                                      *(torch.from_numpy(a) for a in args[:2]), *args[2:])
    np.testing.assert_allclose(ne_t.numpy(), np.asarray(ne_j), rtol=0, atol=1e-6)
    scale = amax * np.float32(1.0 / 127.0)
    assert ne_t.numpy()[0, 1] == x - np.float32(81.0) * scale


def _ae(d, hidden, seed):
    return jax.tree_util.tree_map(np.asarray, jae.init(jax.random.key(seed), d, hidden))


def _train_inputs(n, window, d, bs, epochs, seed):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, window, d)).astype(np.float32)
    keys = jax.random.split(jax.random.key(seed), n)
    idx = np.array(jax.vmap(lambda k: jax_indices(k, window, bs, epochs))(keys))
    return data, idx


TRAIN_CASES = [
    # (n, window, d, hidden, bs, epochs, mu, also against the Pallas kernel)
    (4, 64, 32, (16, 8, 16), 32, 2, 0.0, False),    # the paper AE
    (4, 64, 32, (16, 8, 16), 32, 2, 0.01, False),   # FedProx
    (3, 70, 32, (16, 8, 16), 32, 3, 0.01, True),    # ragged window: tail rows dropped
    (3, 40, 12, (20, 5), 16, 2, 0.0, True),         # a non-paper width
]


@pytest.mark.parametrize("n,window,d,hidden,bs,epochs,mu,pallas", TRAIN_CASES)
def test_local_train_matches_jax_oracle_and_pallas(n, window, d, hidden, bs, epochs, mu, pallas):
    params = _ae(d, hidden, seed=window)
    data, idx = _train_inputs(n, window, d, bs, epochs, seed=window + d)
    assert idx.shape == (n, epochs * (window // bs), bs)
    d_t, l_t = tops.local_train(
        tae.from_numpy(params, "cpu"), torch.from_numpy(data), torch.from_numpy(idx), 0.05, mu
    )
    assert d_t.shape == (n, ravel_pytree(params)[0].shape[0])
    for use_pallas in (False, True) if pallas else (False,):
        d_j, l_j = jops.local_train(
            params, data, idx, 0.05, mu, use_pallas=use_pallas, interpret=True
        )
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), rtol=1e-5)


def test_ravel_matches_jax_ravel_pytree():
    params = _ae(32, (16, 8, 16), seed=9)
    flat_j, unravel_j = ravel_pytree(params)
    tp = tae.from_numpy(params, "cpu")
    flat_t = tae.ravel(tp)
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    back = tae.unravel(flat_t * 2.0, tp)
    for lt, lj in zip(back, unravel_j(flat_j * 2.0)):
        for key in ("w", "b"):
            np.testing.assert_array_equal(lt[key].numpy(), np.asarray(lj[key]))
    with pytest.raises(ValueError):
        tae.unravel(flat_t[:-1], tp)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The launch wrappers take CUDA tensors only; ``kernels/ops`` sends a
    CPU tensor to the plain version and never reaches them."""
    deltas, err, fog_id, weights = (torch.from_numpy(a) for a in _agg_inputs(3, 100, 0))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.compress_aggregate_blocks(deltas, err, fog_id, weights, N_FOG, 5)
    tp = tae.from_numpy(_ae(32, (16, 8, 16), 0), "cpu")
    data = torch.zeros((2, 32, 32))
    idx = torch.zeros((2, 1, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tlt.train_clients(data, idx, tae.ravel(tp), (32, 16, 8, 16, 32), 0.01)
    before = (dict(tfa.LAUNCHES), dict(tlt.LAUNCHES))
    tops.compress_aggregate(deltas, err, fog_id, weights, N_FOG, 0.05)
    tops.local_train(tp, data, idx, 0.01)
    assert (tfa.LAUNCHES, tlt.LAUNCHES) == before


@pytest.mark.parametrize(
    "dims,batch,fits",
    [((32, 16, 8, 16, 32), 32, True), ((130, 64, 8, 64, 130), 32, True),
     ((512, 256, 512), 32, False)],
)
def test_local_train_layout(dims, batch, fits):
    if not fits:
        with pytest.raises(ValueError, match="shared memory"):
            tlt.layout(dims, batch)
        return
    lay = tlt.layout(dims, batch)
    assert lay["n_params"] == tae.param_count(dims[0], dims[1:-1])
    assert all(s % 4 == 0 and s >= dd for s, dd in zip(lay["stride"], dims))
    weights = sum(-(-b // 4) * 4 + a * w for a, b, w in zip(dims, dims[1:], lay["w_stride"]))
    # two gather buffers, the hidden activations, the gradients, the index ring
    rows = batch * (2 * lay["stride"][0] + sum(lay["stride"][1:-1]) + sum(lay["stride"][1:]))
    assert lay["smem"] == 4 * (weights + rows + 3 * batch)


def _layout_buffers(dims, batch):
    """(name, start, size) of every shared-memory buffer of ``layout``."""
    lay = tlt.layout(dims, batch)
    n = len(dims) - 1
    bufs = [(f"bias{li}", lay["pseg_off"][li], dims[li + 1]) for li in range(n)]
    bufs += [(f"w{li}", lay["w_off"][li], dims[li] * lay["w_stride"][li]) for li in range(n)]
    bufs += [(f"x{k}", lay["x_off"][k], batch * lay["stride"][0]) for k in range(2)]
    bufs += [(f"act{li}", lay["act_off"][li], batch * lay["stride"][li]) for li in range(1, n)]
    bufs += [(f"grad{li}", lay["grad_off"][li], batch * lay["stride"][li])
             for li in range(1, n + 1)]
    bufs.append(("idx", lay["idx_off"], 3 * batch))
    return lay, bufs


@pytest.mark.parametrize("batch", [1, 7, 32, 33])
@pytest.mark.parametrize("dims", [(32, 16, 8, 16, 32), (130, 64, 8, 64, 130), (5, 3, 5),
                                  (64, 32, 64)])
def test_local_train_layout_buffers_are_disjoint_and_aligned(dims, batch):
    """The grown layout: every buffer starts on 16 bytes, none overlaps
    another, all lie inside the block's shared memory; weight rows hold
    their width, and rows of a width dividing 32 are packed (32 padded to
    48) for the update's bank pattern."""
    lay, bufs = _layout_buffers(dims, batch)
    spans = sorted((start, start + size, name) for name, start, size in bufs)
    for (s0, e0, n0), (s1, _, n1) in zip(spans, spans[1:]):
        assert e0 <= s1, (n0, n1)
    assert spans[-1][1] * 4 <= lay["smem"]
    assert all(start % 4 == 0 for _, start, _ in bufs)
    for w, s in zip(dims, lay["stride"]):
        assert s == (48 if w == 32 else w if 32 % w == 0 else -(-w // 4) * 4 + 4)
    assert all(ws >= b and ws % 4 == 0 for b, ws in zip(dims[1:], lay["w_stride"]))
    assert lay["seg_off"] == [sum(a * b + b for a, b in zip(dims[:k], dims[1:k + 1]))
                              for k in range(len(dims) - 1)]


@pytest.mark.parametrize("mode", ["blockwise", "global"])
def test_aggregation_operators_match_jax(mode):
    """``core/aggregation`` around the kernel: the normalised
    compress-and-aggregate (blockwise is the fused kernel's operator,
    global the exact Top-K), Eq. 13 fog means, Eq. 15 mixing, Eq. 16 with
    a dead round carried through, and the weighted mean."""
    from repro.core import aggregation as jagg
    from repro.core import compression as jcomp
    from repro.core.cooperation import CoopDecision as JDecision
    from repro_torch.core import aggregation as tagg
    from repro_torch.core import compression as tcomp
    from repro_torch.core.cooperation import CoopDecision as TDecision

    deltas, err, fog_id, weights = _agg_inputs(9, 1352, seed=11, empty_fog=3)
    t = [torch.from_numpy(a) for a in (deltas, err, fog_id, weights)]
    cj = jcomp.CompressorConfig(rho_s=0.05, quant_bits=8, mode=mode)
    ct = tcomp.CompressorConfig(rho_s=0.05, quant_bits=8, mode=mode)
    want = jagg.compress_and_aggregate(deltas, err, fog_id, weights, N_FOG, cj)
    got = tagg.compress_and_aggregate(*t, N_FOG, ct)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-5, atol=1e-5)
    fm_j, fw_j = jagg.fog_aggregate(deltas, fog_id, weights, N_FOG)
    fm_t, fw_t = tagg.fog_aggregate(t[0], t[2], t[3], N_FOG)
    np.testing.assert_allclose(fm_t.numpy(), np.asarray(fm_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(fw_t.numpy(), np.asarray(fw_j), rtol=1e-6)
    part = np.array([1, 0, 3, 3], np.int32)
    sw = np.array([0.8, 1.0, 0.7, 1.0], np.float32)
    dj = JDecision(part, sw, 1.0 - sw, sw < 1.0, np.zeros(4, np.float32))
    dt = TDecision(*(torch.from_numpy(a) for a in (part.astype(np.int64), sw, 1.0 - sw,
                                                   sw < 1.0, np.zeros(4, np.float32))))
    mixed_j = jagg.cooperative_mix(np.asarray(fm_j), dj)
    mixed_t = tagg.cooperative_mix(fm_t, dt)
    np.testing.assert_allclose(mixed_t.numpy(), np.asarray(mixed_j), rtol=1e-6, atol=1e-7)
    prev = deltas[0]
    for fw in (np.array(fw_j), np.zeros(N_FOG, np.float32)):      # a live, then a dead round
        g_ = tagg.global_aggregate(mixed_t, torch.from_numpy(fw), prev=torch.from_numpy(prev))
        w_ = jagg.global_aggregate(np.asarray(mixed_j), fw, prev=prev)
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(g_.numpy(), prev)
    np.testing.assert_allclose(tagg.weighted_mean(t[0], t[3]).numpy(),
                               np.asarray(jagg.weighted_mean(deltas, weights)),
                               rtol=1e-5, atol=1e-6)

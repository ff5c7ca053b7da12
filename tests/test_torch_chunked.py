"""Port parity for the sparse wire and the client-chunked rounds, PyTorch
vs JAX.

- ``compress_wire`` on CPU tensors (``kernels/ref.compress_wire_ref``,
  which the CUDA kernel ``wire_emit`` is held against on the card) vs the
  reference's jitted ``ops.compress_wire(use_pallas=False)``: slot
  indices, code values and scales exactly, new_err to ``atol=1e-5`` (the
  reference's CPU build contracts ``v - q * scale`` into an FMA).
  Quantise on and off; d = 1,352 and 8,209 (whose second block has 17 real
  coordinates, so unused slots point past them); k = 68 and 410.
- ``wire_aggregate`` (``ref.wire_aggregate_ref``, held against
  ``wire_agg``) on the reference's wire: ``rtol=1e-5, atol=1e-4``.
- The reference's chunking pins (``tests/test_chunked_agg.py``) at N = 23:
  chunk >= N is the one-shot path bitwise; chunks 1, 5, 7, 16 match it to
  ``atol=1e-5`` (fog sums), exactly (fog weights) and ``atol=1e-6`` (EF);
  ``client_compress`` is bitwise at every chunk; robust trimmed is bitwise
  chunked; the isfinite guard survives chunking.  The chunked sums also
  match the reference's chunked sums to ``atol=1e-5``.
- Rounds at ``client_chunk=5``, mean and trimmed, vs ``repro.core.hfl``:
  per-round params and ``RoundMetrics`` to ``test_torch_hfl.py``'s
  tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_hfl import (  # noqa: F401  (data is a fixture)
    assert_rounds_match, data, jax_cfg, rounds_both, torch_cfg,
)
from torch_parity import one_intra_op_thread  # noqa: F401

from repro.core import aggregation as jagg
from repro.core import compression as jcomp
from repro.kernels import ops as jops
from repro_torch.core import aggregation as tagg
from repro_torch.core import compression as tcomp
from repro_torch.kernels import ops as tops

CFG_J = jcomp.CompressorConfig(rho_s=0.25, quant_bits=8, mode="blockwise")
CFG_T = tcomp.CompressorConfig(rho_s=0.25, quant_bits=8, mode="blockwise")


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _wire_inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    deltas = rng.standard_normal((n, d)).astype(np.float32)
    err = (0.1 * rng.standard_normal((n, d))).astype(np.float32)
    deltas[1] = 0.0                           # an all-zero row: scale 0, no survivor
    err[1] = 0.0
    return deltas, err


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("k_frac", [68 / 8192, 0.05])
@pytest.mark.parametrize("d", [1352, 8209])
def test_compress_wire_matches_jax(d, k_frac, quantize):
    deltas, err = _wire_inputs(9, d, d)
    want = jops.compress_wire(jnp.asarray(deltas), jnp.asarray(err), k_frac, quantize)
    idx, q, scale, new_err = tops.compress_wire(*_t(deltas, err), k_frac, quantize)
    assert idx.dtype == torch.int32 and q.dtype == (torch.int8 if quantize else torch.float32)
    assert idx.shape == (9, -(-d // 8192), tops.wire_k(k_frac))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(q.to(torch.float32).numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(new_err.numpy(), np.asarray(want[3]), rtol=0, atol=1e-5)
    # The wire reconstructs what the dense path sums.
    fog_sum, ne_dense = tops.compress_aggregate(
        *_t(deltas, err), torch.arange(9, dtype=torch.int32), torch.ones(9), 9, k_frac, quantize)
    recon = torch.zeros((9, idx.shape[1] * 8192))
    rows = torch.arange(9)[:, None, None]
    cols = torch.arange(idx.shape[1])[None, :, None] * 8192 + idx.long()
    recon[rows, cols] = q.to(torch.float32) * scale[..., None]
    np.testing.assert_array_equal(recon[:, :d].numpy(), fog_sum.numpy())
    np.testing.assert_array_equal(new_err.numpy(), ne_dense.numpy())


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("d", [1352, 8209])
def test_wire_aggregate_matches_jax(d, quantize):
    deltas, err = _wire_inputs(30, d, d + 1)
    rng = np.random.default_rng(d)
    fog_id = rng.integers(0, 6, 30).astype(np.int32)
    fog_id[fog_id == 2] = 0                  # fog 2 stays empty
    w = rng.uniform(0.0, 2.0, 30).astype(np.float32)
    w[::4] = 0.0
    idx, q, scale, _ = jops.compress_wire(jnp.asarray(deltas), jnp.asarray(err), 0.05, quantize)
    want = jops.wire_aggregate(idx, q, scale, jnp.asarray(fog_id), jnp.asarray(w), 6, d)
    q_t = torch.from_numpy(np.array(q)).to(torch.int8 if quantize else torch.float32)
    got = tops.wire_aggregate(*_t(idx), q_t, *_t(scale, fog_id, w), 6, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    assert not got[2].any()
    # In place: the sums add to what the buffer holds.
    base = torch.full((6, d), 0.5)
    tops.wire_aggregate(*_t(idx), q_t, *_t(scale, fog_id, w), 6, d, out=base)
    np.testing.assert_allclose(base.numpy(), got.numpy() + 0.5, rtol=1e-6, atol=1e-6)


def _client_order_fold(idx, q, scale, fog_id, w, base):
    """wire_agg's order rule, one client at a time in index order: each
    real slot adds ``(q * scale) * w``, rounded in f32 at each step, to
    the running value of its fog row."""
    out = base.copy()
    n, nb, _ = idx.shape
    d = out.shape[1]
    for i in range(n):
        for b in range(nb):
            cols = b * 8192 + idx[i, b].astype(np.int64)
            real = cols < d
            add = (q[i, b].astype(np.float32) * scale[i, b]) * w[i]
            out[fog_id[i], cols[real]] = out[fog_id[i], cols[real]] + add[real]
    return out


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("d", [1352, 8209])
def test_wire_aggregate_follows_the_client_order_fold(d, quantize):
    """The order rule ``wire_agg`` is held to bitwise on the card: a client
    fold in index order, from a non-zero starting buffer, against the
    plain route of ``ops.wire_aggregate`` and the JAX ``wire_aggregate``
    (``rtol=1e-5, atol=1e-4``: they sum in another order), and bitwise
    against ``ref.wire_fold_ref``, the fold the card runs.  Repeated fogs,
    an empty fog (2), zero weights; at d = 8,209 the second block's slots
    reach into the padding."""
    from repro_torch.kernels import ref as tref

    deltas, err = _wire_inputs(40, d, d + 7)
    rng = np.random.default_rng(d + 3)
    fog_id = rng.integers(0, 5, 40).astype(np.int32)
    fog_id[fog_id == 2] = 0
    fog_id[:6] = 4                               # six clients of one fog in a row
    w = rng.uniform(0.0, 3.0, 40).astype(np.float32)
    w[::5] = 0.0
    base = rng.standard_normal((5, d)).astype(np.float32)
    idx, q, scale, _ = (np.array(a) for a in jops.compress_wire(
        jnp.asarray(deltas), jnp.asarray(err), 0.05, quantize))
    fold = _client_order_fold(idx, q, scale, fog_id, w, base)
    assert np.array_equal(fold[2], base[2])
    q_t = torch.from_numpy(q).to(torch.int8 if quantize else torch.float32)
    args = (torch.from_numpy(idx), q_t, *_t(scale, fog_id, w))
    plain = tops.wire_aggregate(*args, 5, d, out=torch.from_numpy(base.copy()))
    np.testing.assert_allclose(plain.numpy(), fold, rtol=1e-5, atol=1e-4)
    want = base + np.asarray(jops.wire_aggregate(*(jnp.asarray(a) for a in (idx, q, scale)),
                                                 jnp.asarray(fog_id), jnp.asarray(w), 5, d))
    np.testing.assert_allclose(fold, want, rtol=1e-5, atol=1e-4)
    folded = tref.wire_fold_ref(*args, out=torch.from_numpy(base.copy()))
    assert np.array_equal(folded.numpy(), fold)


def _agg_inputs(n=23, d=40, n_fog=4, seed=0):
    """``tests/test_chunked_agg.py``'s inputs, from the same keys."""
    k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
    deltas = jax.random.normal(k1, (n, d))
    err = 0.1 * jax.random.normal(k2, (n, d))
    fog_id = jax.random.randint(k3, (n,), 0, n_fog)
    return (deltas, err, fog_id.astype(jnp.int32), jnp.ones((n,))), n_fog


def _port(args):
    return _t(*args)


@pytest.mark.parametrize("chunk", [None, 23, 64])
def test_chunk_ge_n_is_bitwise_the_one_shot_path(chunk):
    args, n_fog = _agg_inputs()
    ref = tagg.compress_and_accumulate(*_port(args), n_fog, CFG_T)
    out = tagg.compress_and_accumulate(*_port(args), n_fog, CFG_T, chunk=chunk)
    for a, b in zip(ref, out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("chunk", [1, 5, 7, 16])
def test_chunked_matches_one_shot_and_jax(chunk):
    args, n_fog = _agg_inputs()
    ref = tagg.compress_and_accumulate(*_port(args), n_fog, CFG_T)
    out = tagg.compress_and_accumulate(*_port(args), n_fog, CFG_T, chunk=chunk)
    np.testing.assert_allclose(out[0].numpy(), ref[0].numpy(), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out[1].numpy(), ref[1].numpy())
    np.testing.assert_allclose(out[2].numpy(), ref[2].numpy(), rtol=0, atol=1e-6)
    want = jagg.compress_and_accumulate(*args, n_fog, CFG_J, chunk=chunk)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(out[2].numpy(), np.asarray(want[2]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("chunk", [1, 5, 23, 64])
def test_client_compress_bitwise_at_every_chunk(chunk):
    args, _ = _agg_inputs()
    deltas, err = _port(args)[:2]
    ref = tagg.client_compress(deltas, err, CFG_T)
    out = tagg.client_compress(deltas, err, CFG_T, chunk=chunk)
    for a, b in zip(ref, out):
        assert torch.equal(a, b)


def test_robust_trimmed_chunked_bitwise_and_matches_jax():
    args, n_fog = _agg_inputs()
    ref = tagg.robust_compress_and_aggregate(*_port(args), n_fog, CFG_T, 0.2, "trimmed")
    out = tagg.robust_compress_and_aggregate(*_port(args), n_fog, CFG_T, 0.2, "trimmed", chunk=5)
    for a, b in zip(ref, out):
        assert torch.equal(a, b)
    want = jagg.robust_compress_and_aggregate(*args, n_fog, CFG_J, 0.2, "trimmed", chunk=5)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(out[2].numpy(), np.asarray(want[2]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("robust", [False, True])
def test_nonfinite_guard_survives_chunking(robust):
    args, n_fog = _agg_inputs()
    deltas, err, fog_id, w = _port(args)
    deltas[3, 1], deltas[11, 0] = float("inf"), float("nan")
    if robust:
        fog, fog_w, new_err = tagg.robust_compress_and_aggregate(
            deltas, err, fog_id, w, n_fog, CFG_T, 0.2, "trimmed", chunk=5)
    else:
        fog, fog_w, new_err = tagg.compress_and_accumulate(
            deltas, err, fog_id, w, n_fog, CFG_T, chunk=5)
    assert bool(torch.isfinite(fog).all()) and bool(torch.isfinite(new_err).all())
    assert float(fog_w.sum()) == deltas.shape[0] - 2


@pytest.mark.parametrize("robust", ["mean", "trimmed"])
def test_chunked_rounds_match_jax(data, robust):
    kw = dict(client_chunk=5, robust=robust, trim_frac=0.3 if robust == "trimmed" else 0.0)
    assert_rounds_match(rounds_both(data, 30, jax_cfg(**kw), torch_cfg(**kw)))


def test_chunked_global_mode_takes_the_dense_per_chunk_path():
    """A config the wire does not take (``mode="global"``) compresses each
    chunk densely, as the reference does."""
    args, n_fog = _agg_inputs()
    cfg_j, cfg_t = jcomp.CompressorConfig(mode="global"), tcomp.CompressorConfig(mode="global")
    out = tagg.compress_and_accumulate(*_port(args), n_fog, cfg_t, chunk=7)
    want = jagg.compress_and_accumulate(*args, n_fog, cfg_j, chunk=7)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(out[2].numpy(), np.asarray(want[2]), rtol=0, atol=1e-5)

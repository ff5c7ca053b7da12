"""Port parity for the per-client blockwise compressor, PyTorch vs JAX.

The same numpy-seeded inputs go through ``repro.kernels.ops`` /
``repro.core`` and through ``repro_torch`` on the CPU, where the port runs
the plain versions (``kernels/ref.compress_ref``, ``blockwise_topk_ef_ref``,
``quant8_ref``) that the CUDA kernels ``compress_q8``, ``topk_ef`` and
``quant8`` are held against on the card.  The reference runs both its
jnp oracle and its Pallas kernels (``compress_blocks``, ``topk_ef_blocks``,
``quant8_blocks``) in interpret mode.

Tolerances.  q, scales, sparse values, reconstructions, survivor sets and
payload bits exactly.  new_err of the int8 path to ``atol=1e-6``: under
``jit`` XLA:CPU contracts the reference's ``v - q * scale`` into one fused
multiply-add, while the port rounds the product first (on the card too,
``__fmul_rn`` then ``__fsub_rn``); both residuals are pinned bit for bit
to their own rule by :func:`test_compress_new_err_is_the_unfused_residual`.  The fused=False
round operators: fog sums to ``rtol=1e-5, atol=1e-4`` and error-feedback
buffers to ``atol=1e-5`` (``tests/test_fused_agg.py``'s pins).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import compression as jcomp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import aggregation as tagg
from repro_torch.core import compression as tcomp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

BLOCK = 8192
DS = [1352, 8209, 65536]
RHOS = [0.05, 1.0, 1.0 / 8192]
EF_ATOL = 1e-6


def _rows(d, seed, k):
    """Four rows of (delta, err): Gaussian, Gaussian with a larger error
    buffer, all zeros, and more than k entries per block tied at the block
    max (as many as the block's real width allows)."""
    rng = np.random.default_rng(seed)
    delta = rng.standard_normal((4, d)).astype(np.float32)
    err = (0.1 * rng.standard_normal((4, d))).astype(np.float32)
    err[1] *= 10.0
    delta[2] = err[2] = 0.0
    delta[3] *= 0.1
    err[3] = 0.0
    for b in range(-(-d // BLOCK)):
        lo = b * BLOCK
        t = min(d - lo, BLOCK, k + 3)
        delta[3, lo:lo + t] = np.where(np.arange(t) % 2 == 0, 5.0, -5.0)
    return delta, err


def _tied_blocks(d, k):
    """Start columns of the blocks where :func:`_rows`' last row ties more
    than k entries at the block max."""
    return [lo for lo in range(0, d, BLOCK) if min(d - lo, BLOCK, k + 3) > k]


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


@pytest.mark.parametrize("rho_s", RHOS)
@pytest.mark.parametrize("d", DS)
def test_compress_matches_jax_oracle_and_pallas(d, rho_s):
    k_frac = tcomp.blockwise_k_frac(d, rho_s)
    assert k_frac == jcomp.blockwise_k_frac(d, rho_s)
    delta, err = _rows(d, d, tops.block_k(k_frac))
    recon, new_err, bits = tops.compress(*_t(delta, err), k_frac)
    assert recon.shape == new_err.shape == (4, d) and bits.shape == (4,)
    for i in range(4):
        for use_pallas in (False, True):
            r_j, e_j, b_j = jops.compress(jnp.asarray(delta[i]), jnp.asarray(err[i]), k_frac,
                                          use_pallas=use_pallas)
            np.testing.assert_array_equal(recon[i].numpy(), np.asarray(r_j))
            np.testing.assert_allclose(new_err[i].numpy(), np.asarray(e_j), rtol=0, atol=EF_ATOL)
            assert float(bits[i]) == float(b_j)
    assert not recon[2].any()
    for lo in _tied_blocks(d, tops.block_k(k_frac)):            # nothing survives a tie
        assert not recon[3, lo:lo + BLOCK].any()
        np.testing.assert_array_equal(new_err[3, lo:lo + BLOCK].numpy(), delta[3, lo:lo + BLOCK])


@pytest.mark.parametrize("rho_s", RHOS)
@pytest.mark.parametrize("d", DS)
def test_topk_ef_matches_jax_oracle_and_pallas(d, rho_s):
    k_frac = tcomp.blockwise_k_frac(d, rho_s)
    delta, err = _rows(d, d + 1, tops.block_k(k_frac))
    sparse, new_err = tops.topk_ef(*_t(delta, err), k_frac)
    for i in range(4):
        for use_pallas in (False, True):
            s_j, e_j = jops.topk_ef(jnp.asarray(delta[i]), jnp.asarray(err[i]), k_frac,
                                    use_pallas=use_pallas)
            np.testing.assert_array_equal(sparse[i].numpy(), np.asarray(s_j))
            np.testing.assert_array_equal(new_err[i].numpy(), np.asarray(e_j))
    np.testing.assert_array_equal((sparse + new_err).numpy(), delta + err)


@pytest.mark.parametrize("d", DS)
def test_compress_new_err_is_the_unfused_residual(d):
    """new_err is v minus the rounded product q * scale in the port, and
    the fused multiply-add of the same q and scale in the jitted
    reference; nothing else separates them.  (Emulated in f64: q * scale
    is exact there, and so is v minus it, since the two are within a
    factor of 2 of each other wherever q != 0.)"""
    k = tops.block_k(tcomp.blockwise_k_frac(d, 0.05))
    delta, err = _rows(d, 3 * d, k)
    q, scale, new_err = tref.compress_ref(*_t(delta, err), k)
    v = delta + err
    per_col = scale.numpy()[:, np.arange(d) // BLOCK]
    prod = q.numpy().astype(np.float32) * per_col
    np.testing.assert_array_equal(new_err.numpy(), v - prod)
    fma = (v.astype(np.float64) - q.numpy().astype(np.float64) * per_col).astype(np.float32)
    for i in range(4):
        _, e_j, _ = jops.compress(jnp.asarray(delta[i]), jnp.asarray(err[i]),
                                  tcomp.blockwise_k_frac(d, 0.05))
        np.testing.assert_array_equal(np.asarray(e_j), fma[i])
    assert np.any(fma != new_err.numpy())


def test_tie_at_the_block_max_keeps_nothing_and_scale_zero():
    """More than k entries at the block max: nothing survives, so the
    compressor's scale is 0 (``max|sparse| / 127``), while the fused path
    keeps the block max's scale over its all-zero reconstruction."""
    d, k = 1352, 68
    delta, err = _rows(d, 5, k)
    q, scale, new_err = tref.compress_ref(*_t(delta, err), k)
    assert float(scale[3, 0]) == 0.0 and not q[3].any()
    assert float(scale[2, 0]) == 0.0
    np.testing.assert_array_equal(new_err[3].numpy(), delta[3])
    _, fused_err, thr = tref.compress_aggregate_ref(
        *_t(delta, err, np.zeros(4, np.int32), np.ones(4, np.float32)), 1, k)
    assert float(thr[3, 0]) == 5.0
    np.testing.assert_array_equal(fused_err.numpy(), new_err.numpy())


def test_quant8_scale_is_the_f32_reciprocal_product_at_many_blocks():
    """128 blocks over six decades of magnitude: the scales equal the
    reference's bit for bit, and on these blocks ``amax / 127`` rounded as
    a true division differs from ``amax * f32(1/127)``, so the test tells
    the two rules apart."""
    rng = np.random.default_rng(0)
    nb = 64
    mag = (10.0 ** rng.uniform(-3, 3, (2, nb, 1))).astype(np.float32)
    x = (rng.standard_normal((2, nb, BLOCK)) * mag).astype(np.float32).reshape(2, -1)
    x[1, :BLOCK] = 0.0                                          # an all-zero block
    q, scale, n = tops.quant8(torch.from_numpy(x))
    assert q.shape == (2, nb, BLOCK) and q.dtype == torch.int8 and scale.shape == (2, nb, 1)
    assert n == nb * BLOCK and float(scale[1, 0, 0]) == 0.0 and not q[1, 0].any()
    amax = np.abs(x.reshape(2, nb, BLOCK)).max(-1)
    assert np.any(amax / np.float32(127) != amax * np.float32(1 / 127))
    for i in range(2):
        for use_pallas in (False, True):
            q_j, s_j, n_j = jops.quant8(jnp.asarray(x[i]), use_pallas=use_pallas)
            np.testing.assert_array_equal(q[i].numpy(), np.asarray(q_j))
            np.testing.assert_array_equal(scale[i].numpy(), np.asarray(s_j))
            assert n_j == n
        dq_j = np.asarray(jref.dequant8_ref(q_j, s_j)).reshape(-1)[:n]
        np.testing.assert_array_equal(tops.dequant8(q, scale, n)[i].numpy(), dq_j)


@pytest.mark.parametrize("d", [1352, 8209])
def test_quant8_pads_the_tail_block_with_zero_codes(d):
    x = np.random.default_rng(d).standard_normal((3, d)).astype(np.float32)
    q, scale, n = tops.quant8(torch.from_numpy(x))
    assert q.shape == (3, -(-d // BLOCK), BLOCK) and n == d
    assert not q.reshape(3, -1)[:, d:].any()
    for i in range(3):
        q_j, s_j, _ = jops.quant8(jnp.asarray(x[i]), use_pallas=True)
        np.testing.assert_array_equal(q[i].numpy(), np.asarray(q_j))
        np.testing.assert_array_equal(scale[i].numpy(), np.asarray(s_j))
    np.testing.assert_allclose(tops.dequant8(q, scale, n).numpy(), x,
                               atol=float(scale.max()) / 2 * 1.0001)


@pytest.mark.parametrize("d", [1352, 8209])
def test_payload_bits_count_kept_codes(d):
    k_frac = tcomp.blockwise_k_frac(d, 0.05)
    delta, err = _rows(d, 7, tops.block_k(k_frac))
    recon, _, bits = tops.compress(*_t(delta, err), k_frac)
    b_idx = int(np.ceil(np.log2(d)))
    np.testing.assert_array_equal(bits.numpy(), (recon != 0).sum(1).numpy() * (8.0 + b_idx))
    assert float(bits[0]) <= round(0.05 * d) * (8 + b_idx)


def test_fused_and_per_client_paths_share_survivors():
    d = 8209
    k = tops.block_k(tcomp.blockwise_k_frac(d, 0.05))
    delta, err = _rows(d, 11, k)
    sparse, _ = tref.blockwise_topk_ef_ref(*_t(delta, err), k)
    _, _, thr = tref.compress_aggregate_ref(
        *_t(delta, err, np.zeros(4, np.int32), np.ones(4, np.float32)), 1, k)
    absv = tref.pad_blocks(torch.from_numpy(delta + err)).abs()
    survive = tref.unpad_rows(absv > thr[..., None], d)
    np.testing.assert_array_equal((sparse != 0).numpy(), survive.numpy())


CFGS = {
    "int8": dict(rho_s=0.05, quant_bits=8),
    "f32": dict(rho_s=0.05, quant_bits=32),
    "dense-int8": dict(rho_s=1.0, quant_bits=8),
}


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", list(CFGS))
def test_compress_update_matches_jax(name, use_pallas):
    d = 1352
    delta, err = _rows(d, 13, 68)
    cfg_j = jcomp.CompressorConfig(mode="blockwise", use_pallas=use_pallas, **CFGS[name])
    recon, new_err = tcomp.compress_update(*_t(delta, err),
                                           tcomp.CompressorConfig(mode="blockwise", **CFGS[name]))
    r_j, e_j = jax.vmap(lambda a, b: jcomp.compress_update(a, b, cfg_j))(
        jnp.asarray(delta), jnp.asarray(err))
    np.testing.assert_array_equal(recon.numpy(), np.asarray(r_j))
    np.testing.assert_allclose(new_err.numpy(), np.asarray(e_j), rtol=0, atol=EF_ATOL)
    one_r, one_e = tcomp.compress_update(*_t(delta[0], err[0]),
                                         tcomp.CompressorConfig(mode="blockwise", **CFGS[name]))
    assert one_r.shape == (d,)
    np.testing.assert_array_equal(one_r.numpy(), recon[0].numpy())
    np.testing.assert_array_equal(one_e.numpy(), new_err[0].numpy())


def _round_inputs(n, d, n_fog, seed):
    rng = np.random.default_rng(seed)
    deltas = rng.standard_normal((n, d)).astype(np.float32)
    err = (0.1 * rng.standard_normal((n, d))).astype(np.float32)
    fog_id = rng.integers(0, n_fog, n).astype(np.int32)
    weights = (48.0 * (rng.random(n) > 0.3)).astype(np.float32)
    deltas[4, 7] = np.nan                                      # a diverged client
    return deltas, err, fog_id, weights


@pytest.mark.parametrize("chunk", [None, 4])
@pytest.mark.parametrize("name", list(CFGS))
def test_unfused_compress_and_accumulate_matches_jax(name, chunk):
    n, d, n_fog = 10, 1352, 3
    deltas, err, fog_id, weights = _round_inputs(n, d, n_fog, 17)
    cfg_t = tcomp.CompressorConfig(fused=False, **CFGS[name])
    cfg_j = jcomp.CompressorConfig(mode="blockwise", fused=False, **CFGS[name])
    fs_t, fw_t, ne_t = tagg.compress_and_accumulate(
        *_t(deltas, err, fog_id, weights), n_fog, cfg_t, chunk=chunk)
    fs_j, fw_j, ne_j = jagg.compress_and_accumulate(
        *(jnp.asarray(x) for x in (deltas, err, fog_id, weights)), n_fog, cfg_j, chunk=chunk)
    np.testing.assert_allclose(fs_t.numpy(), np.asarray(fs_j), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(fw_t.numpy(), np.asarray(fw_j))
    np.testing.assert_allclose(ne_t.numpy(), np.asarray(ne_j), rtol=0, atol=1e-5)
    assert np.isfinite(fs_t.numpy()).all() and not ne_t[4].any()


@pytest.mark.parametrize("chunk", [None, 4])
@pytest.mark.parametrize("name", ["int8", "f32"])
def test_unfused_client_compress_matches_jax(name, chunk):
    n, d = 10, 1352
    deltas, err, _, _ = _round_inputs(n, d, 1, 19)
    recon, new_err = tagg.client_compress(
        *_t(deltas, err), tcomp.CompressorConfig(fused=False, **CFGS[name]), chunk=chunk)
    r_j, e_j = jagg.client_compress(
        jnp.asarray(deltas), jnp.asarray(err),
        jcomp.CompressorConfig(mode="blockwise", fused=False, **CFGS[name]), chunk=chunk)
    np.testing.assert_array_equal(recon.numpy(), np.asarray(r_j))
    np.testing.assert_allclose(new_err.numpy(), np.asarray(e_j), rtol=0, atol=EF_ATOL)


def test_unfused_matches_fused_survivors_and_sums():
    """The legacy pipeline against the fused one inside the port: the same
    error-feedback state and fog sums up to summation order."""
    n, d, n_fog = 10, 1352, 3
    deltas, err, fog_id, weights = _round_inputs(n, d, n_fog, 23)
    args = _t(deltas, err, fog_id, weights)
    fused = tagg.compress_and_accumulate(*args, n_fog, tcomp.CompressorConfig())
    legacy = tagg.compress_and_accumulate(*args, n_fog, tcomp.CompressorConfig(fused=False))
    np.testing.assert_allclose(legacy[0].numpy(), fused[0].numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(legacy[1].numpy(), fused[1].numpy())
    np.testing.assert_array_equal(legacy[2].numpy(), fused[2].numpy())

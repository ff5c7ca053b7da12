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
from torch_parity import one_intra_op_thread  # noqa: F401

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


def _bisect_counting_real(real_abs, n_pad, k, iters=tref.BISECT_ITERS):
    """The kernels' bisection: counts over the real values only, plus the
    padding's n_pad * [mid < 0] (|0| > mid exactly when mid < 0)."""
    lo = torch.full(real_abs.shape[:-1] + (1,), -1.0)
    hi = torch.amax(real_abs, dim=-1, keepdim=True) if real_abs.shape[-1] else torch.zeros_like(lo)
    hi = torch.maximum(hi, torch.zeros_like(hi))
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cnt = torch.sum(real_abs > mid, dim=-1, keepdim=True) + n_pad * (mid < 0)
        take = cnt > k
        lo = torch.where(take, mid, lo)
        hi = torch.where(take, hi, mid)
    return hi


def _identity_cases():
    rng = np.random.default_rng(7)
    gauss = rng.standard_normal((3, 1352)).astype(np.float32)
    return {
        "gaussian": (gauss, 68),
        "amax below 1": (1e-3 * gauss, 68),
        "all zero": (np.zeros((2, 1352), np.float32), 68),
        "ties at the max": (np.where(np.arange(1352) % 2 == 0, 5.0, -5.0)[None].astype(np.float32), 68),
        "k above the width": (rng.standard_normal((2, 17)).astype(np.float32), 68),
        "k = 8192": (rng.standard_normal((2, 8209 - 8192)).astype(np.float32), 8192),
        "k among the padding's zeros": (rng.standard_normal((2, 17)).astype(np.float32), 8000),
        "k = 1": (gauss, 1),
        "a full block": (rng.standard_normal((2, 8192)).astype(np.float32), 410),
    }


@pytest.mark.parametrize("case", list(_identity_cases()))
def test_padding_count_identity(case):
    """ref.bisect_threshold over a zero-padded 8,192-block equals the
    bisection that counts the real values and adds n_pad * [mid < 0]:
    the threshold wire_emit's team selection computes, bit for bit."""
    x, k = _identity_cases()[case]
    real = torch.from_numpy(np.abs(x))
    width = real.shape[-1]
    padded = torch.nn.functional.pad(real, (0, BLOCK - width))
    want = tref.bisect_threshold(padded, k)
    got = _bisect_counting_real(real, BLOCK - width, k)
    assert torch.equal(got, want)


def _bisect_team(real_abs, k):
    """team_threshold, step for step: kFullSteps (8) steps counting the
    held slots (the real values, zeros up to the team's held width) plus
    the unheld padding's n * [mid < 0]; then only the nonzero candidates,
    0 < |v| <= hi and |v| > lo, beside the count above hi, and a mid below
    0 counted as the whole block."""
    from repro_torch.kernels import teams

    width = real_abs.shape[-1]
    slots = next((s for s in teams.SMALL_SLOTS if teams.SMALL_TEAM * s >= width), None)
    held = teams.SMALL_TEAM * slots if teams.team_threads(width) == teams.SMALL_TEAM else BLOCK
    out = []
    for row in real_abs:
        a = torch.nn.functional.pad(row, (0, held - width))
        lo, hi = torch.tensor(-1.0), torch.amax(a)
        for _ in range(8):
            mid = 0.5 * (lo + hi)
            cnt = int((a > mid).sum()) + (BLOCK - held) * bool(mid < 0)
            lo, hi = (mid, hi) if cnt > k else (lo, mid)
        cand = a[(a > torch.clamp(lo, min=0.0)) & ~(a > hi)]
        above = int((a > hi).sum())
        for _ in range(8, tref.BISECT_ITERS):
            mid = 0.5 * (lo + hi)
            cnt = BLOCK if mid < 0 else above + int((cand > mid).sum())
            lo, hi = (mid, hi) if cnt > k else (lo, mid)
        out.append(hi.reshape(1))
    return torch.stack(out)


@pytest.mark.parametrize("case", list(_identity_cases()))
def test_team_candidate_list_identity(case):
    """team_threshold's last steps, which count a mid below 0 as the whole
    padded block and otherwise read only the nonzero candidates, give
    ref.bisect_threshold's threshold bit for bit, with k at and above the
    width (lo and hi close in on 0, where every held zero would be a
    candidate), k among the padding's zeros, k = 8,192 (hi < 0), all-zero
    rows and ties."""
    x, k = _identity_cases()[case]
    real = torch.from_numpy(np.abs(x))
    padded = torch.nn.functional.pad(real, (0, BLOCK - real.shape[-1]))
    assert torch.equal(_bisect_team(real, k), tref.bisect_threshold(padded, k))


def _pack_order(v, hi, k):
    """wire_emit's slot order for one padded block v (8,192,): the ranked
    elements (|v| > max(hi, 0)) by (|v| descending, index), then each other
    position e with e - (ranked below e) < k - s at slot s + that; a
    position of the padding past the held tiles lands in slot e."""
    a = v.abs()
    ranked = a > max(hi, 0.0)
    s = int(ranked.sum())
    order = sorted(torch.nonzero(ranked).flatten().tolist(), key=lambda e: (-float(a[e]), e))
    slots = order + [-1] * (k - s)
    below = torch.cumsum(ranked.to(torch.int64), 0) - ranked.to(torch.int64)
    for e in range(BLOCK):
        if not ranked[e] and e - int(below[e]) < k - s:
            slots[s + e - int(below[e])] = e
    return slots


@pytest.mark.parametrize("case", list(_identity_cases()))
def test_wire_pack_order_is_the_plain_versions(case):
    """The pack rule of the wire_emit kernel gives compress_wire_ref's slot
    order: survivors first, then the lowest-index others, with k at and
    above the width and k = 8,192 (hi < 0: the zeros rank by index)."""
    x, k = _identity_cases()[case]
    delta = torch.from_numpy(x)
    idx, _, _, _ = tref.compress_wire_ref(delta, torch.zeros_like(delta), k)
    v = tref.pad_blocks(delta)
    hi = tref.bisect_threshold(v.abs(), k)
    for row in range(delta.shape[0]):
        assert _pack_order(v[row, 0], float(hi[row, 0, 0]), k) == idx[row, 0].tolist()


@pytest.mark.parametrize(
    "n,d,k,want",
    [(512, 1352, 68, (0, 0, 24, 128, 256, 68)),    # fleet-10k's chunk: 2 two-warp teams a block
     (200, 1352, 68, (0, 0, 24, 64, 200, 68)),     # train-200: a team a block
     (5, 1352, 68, (0, 0, 24, 64, 5, 68)),
     (2000, 1352, 68, (0, 0, 24, 256, 500, 68)),
     (200, 8209, 68, (1, 68, 8, 64, 200, 17)),     # a block team and a 17-wide small team per row
     (3, 65536, 8192, (8, 8192, 0, 0, 0, 0)),      # full blocks only
     (4, 8191, 68, (1, 68, 0, 0, 0, 0)),           # a last block too wide for a small team
     (4, 2048, 4096, (0, 0, 32, 64, 4, 2048)),
     (4, 1024, 68, (0, 0, 16, 64, 4, 68))],
)
def test_wire_plan_at_the_main_paths_shapes(n, d, k, want):
    """wire_emit's teams and grid on an H100 SXM's 132 SMs: (block-team
    blocks per row, their shared-memory cap, a small team's slots a thread,
    threads and blocks of small teams, their cap)."""
    from repro_torch.kernels import fused_agg as fa

    p = fa.wire_plan(n, d, k, 132)
    assert (p.n_wide, p.cap_wide, p.slots, p.threads, p.narrow_grid, p.cap_narrow) == want
    assert p.smem_wide == (fa.team_region(8192, p.cap_wide) if p.n_wide else 0)
    teams = p.threads // fa.SMALL_TEAM
    assert p.smem_narrow == teams * fa.team_region(fa.SMALL_TEAM * p.slots, p.cap_narrow)
    regions = [(p.smem_wide, 8192, p.cap_wide)] if p.n_wide else []
    if teams:
        regions.append((p.smem_narrow // teams, fa.SMALL_TEAM * p.slots, p.cap_narrow))
    for region, held, cap in regions:
        assert region >= 4 * held                                     # candidates, then keys
        assert region >= fa.SLOT_BYTES * cap + 8 * fa.RANK_PAD
    assert max(p.smem_wide, p.smem_narrow) <= fa.SMEM_MAX


@pytest.mark.parametrize(
    "n,d,n_fog,want",
    [(200, 1352, 20, (0, 24, 1, 200, 1)),        # train-200: 11 tiles x 20 fogs = 220 sum blocks
     (200, 1352, 200, (0, 24, 1, 200, 4)),       # robust-200's identity call
     (64, 1352, 64, (0, 24, 1, 64, 4)),          # its chunk of 64
     (10_000, 1352, 1000, (0, 24, 4, 2500, 4)),  # fleet-10k unchunked
     (66_000, 64, 66_000, (0, 8, 4, 16_500, 1)),
     (200, 8209, 20, (1, 8, 1, 200, 4)),
     (200, 65536, 20, (8, 8, 1, 0, 4))],
)
def test_dense_plan_at_the_main_paths_shapes(n, d, n_fog, want):
    """fused_agg's launches on an H100 SXM's 132 SMs: the select launch's
    teams are wire_emit's, and the fog sums' tiles lie inside one
    8192-block, are no wider than the row unless one thread-column is, and
    give one block per SM or more wherever some tile width does."""
    from repro_torch.kernels import fused_agg as fa

    p = fa.dense_plan(n, d, n_fog, 132)
    assert (p.n_wide, p.slots, p.teams, p.narrow_grid, p.cols) == want
    w = fa.wire_plan(n, d, 68, 132)
    assert (p.n_wide, p.narrow_grid) == (w.n_wide, w.narrow_grid)
    assert p.teams * fa.SMALL_TEAM == max(w.threads, fa.SMALL_TEAM)
    tile = fa.SUM_THREADS * p.cols
    assert 8192 % tile == 0 and (tile <= d or p.cols == 1)
    if n_fog * -(-d // fa.SUM_THREADS) >= 132:
        assert n_fog * -(-d // tile) >= 132


@pytest.mark.parametrize(
    "n,d,want",
    [(200, 1352, (0, 24, 1, 200)),        # train-200 and legacy-200: a two-warp team a block
     (512, 1352, (0, 24, 2, 256)),        # fleet-10k's chunk
     (2000, 1352, (0, 24, 4, 500)),
     (200, 8209, (1, 8, 1, 200)),         # a block team and a 17-wide small team per row
     (3, 65536, (8, 8, 1, 0)),            # full blocks only
     (4, 8191, (1, 8, 1, 0))],            # a last block too wide for a small team
)
def test_compress_plan_is_the_wire_and_dense_teams(n, d, want):
    """compress_q8's and topk_ef's teams on an H100 SXM's 132 SMs: (block
    teams per row, a small team's slots, small teams a block, blocks of
    small teams), the teams of wire_emit's and fused_agg's select launches."""
    from repro_torch.kernels import fused_agg as fa
    from repro_torch.kernels import teams

    p = teams.compress_plan(n, d, 132)
    assert tuple(p) == want
    w = fa.wire_plan(n, d, 68, 132)
    assert (p.n_wide, p.narrow_grid) == (w.n_wide, w.narrow_grid)
    if p.narrow_grid:
        assert (p.slots, p.teams * teams.SMALL_TEAM) == (w.slots, w.threads)
    assert tuple(fa.dense_plan(n, d, 20, 132))[:4] == tuple(p)


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("quantize", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("case", list(_identity_cases()))
def test_per_client_plain_versions_are_the_dense_select(case, quantize):
    """compress_ref and blockwise_topk_ef_ref are the dense select's
    outputs (compress_aggregate_ref, _dense_recon) with only the int8
    scale's rule changed: max|sparse| / 127, so 0 where nothing survives
    (scale = where(amax > thr, amax * f32(1/127), 0)).  What lets
    compress_q8 and topk_ef write what fused_agg's select team writes,
    given that scale."""
    x, k = _identity_cases()[case]
    rng = np.random.default_rng(11)
    delta = torch.from_numpy(x)
    err = torch.from_numpy((0.1 * rng.standard_normal(x.shape)).astype(np.float32))
    if not x.any():
        err = torch.zeros_like(err)
    n, d = delta.shape
    _, dense_err, thr = tref.compress_aggregate_ref(
        delta, err, torch.zeros(n, dtype=torch.int32), torch.ones(n), 1, k, quantize)
    _, recon, _ = tref._dense_recon(delta, err, k, quantize)
    recon = tref.unpad_rows(recon, d)
    if quantize:
        q, scale, new_err = tref.compress_ref(delta, err, k)
        amax = tref.pad_blocks(delta + err).abs().amax(-1)
        want_scale = torch.where(amax > thr, amax * np.float32(1 / 127), 0.0)
        assert torch.equal(_bits(scale), _bits(want_scale))
        per_col = scale.repeat_interleave(BLOCK, dim=1)[:, :d]
        assert torch.equal(q.to(torch.float32) * per_col, recon)
    else:
        sparse, new_err = tref.blockwise_topk_ef_ref(delta, err, k)
        assert torch.equal(_bits(sparse), _bits(recon))
    assert torch.equal(_bits(new_err), _bits(dense_err))


@pytest.mark.parametrize("width,threads", [(1, 64), (1352, 64), (2048, 64), (2049, 256),
                                           (8192, 256)])
def test_wire_team_size_by_width(width, threads):
    from repro_torch.kernels import fused_agg as fa

    assert fa.team_threads(width) == threads


def _wire_case(d, seed, bad):
    rng = np.random.default_rng(seed)
    deltas = rng.standard_normal((6, d)).astype(np.float32)
    err = (0.1 * rng.standard_normal((6, d))).astype(np.float32)
    fog_id = np.array([0, 1, 2, bad, 0, 1], np.int32)
    weights = np.array([48.0, 32.0, 16.0, 64.0, 48.0, 8.0], np.float32)
    return deltas, err, fog_id, weights


@pytest.mark.parametrize("quantize", [True, False], ids=["int8", "f32"])
def test_compress_aggregate_wire_drops_a_fog_id_of_n_fog_as_the_reference_does(quantize):
    """The wire operator with one client's id ``n_fog``: both packages drop
    it (its error feedback still advances), as the dense path does."""
    deltas, err, fog_id, weights = _wire_case(1352, 21, 3)
    fs_t, ne_t = tops.compress_aggregate_wire(*_t(deltas, err, fog_id, weights), 3, 0.05,
                                              quantize)
    fs_j, ne_j = jops.compress_aggregate_wire(
        *(jnp.asarray(x) for x in (deltas, err, fog_id, weights)), 3, 0.05, quantize,
        use_pallas=False)
    np.testing.assert_allclose(fs_t.numpy(), np.asarray(fs_j), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ne_t.numpy(), np.asarray(ne_j), rtol=0, atol=1e-5)
    dense, _ = tops.compress_aggregate(*_t(deltas, err, fog_id, weights), 3, 0.05, quantize)
    np.testing.assert_allclose(fs_t.numpy(), dense.numpy(), rtol=1e-5, atol=1e-4)


def test_wire_drops_a_negative_fog_id_where_the_reference_oracle_wraps_it():
    """Pinned divergence: the reference's wire oracle adds a client of id
    -1 into the last fog (``.at[]`` wraps negative indices), while its
    dense path and ``jax.ops.segment_sum`` drop it; the port drops it on
    both paths."""
    deltas, err, fog_id, weights = _wire_case(1352, 22, -1)
    args = (deltas, err, fog_id, weights)
    fs_t, _ = tops.compress_aggregate_wire(*_t(*args), 3, 0.05)
    dense_t, _ = tops.compress_aggregate(*_t(*args), 3, 0.05)
    fs_j, _ = jops.compress_aggregate_wire(*(jnp.asarray(x) for x in args), 3, 0.05,
                                           use_pallas=False)
    dense_j, _ = jops.compress_aggregate(*(jnp.asarray(x) for x in args), 3, 0.05,
                                         use_pallas=False)
    np.testing.assert_allclose(fs_t.numpy(), dense_t.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(dense_t.numpy(), np.asarray(dense_j), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(fs_t.numpy()[:2], np.asarray(fs_j)[:2], rtol=1e-5, atol=1e-4)
    wrapped = np.asarray(fs_j)[2] - fs_t.numpy()[2]
    assert np.abs(wrapped).max() > 1e-3                    # client 3 landed in fog 2 there
    keep = fog_id >= 0
    alone, _ = tops.compress_aggregate_wire(
        *_t(deltas[~keep], err[~keep], np.array([2], np.int32), weights[~keep]), 3, 0.05)
    np.testing.assert_allclose(wrapped, alone.numpy()[2], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("chunk", [None, 2, 4])
def test_compress_and_accumulate_drops_a_fog_id_of_n_fog(chunk):
    """The round operator with one id ``n_fog`` (the fused path, and the
    sparse wire chunk by chunk): the reference's sums and weights."""
    deltas, err, fog_id, weights = _wire_case(1352, 23, 3)
    cfg_t, cfg_j = tcomp.CompressorConfig(), jcomp.CompressorConfig(mode="blockwise")
    fs_t, fw_t, ne_t = tagg.compress_and_accumulate(*_t(deltas, err, fog_id, weights), 3, cfg_t,
                                                    chunk=chunk)
    fs_j, fw_j, ne_j = jagg.compress_and_accumulate(
        *(jnp.asarray(x) for x in (deltas, err, fog_id, weights)), 3, cfg_j, chunk=chunk)
    np.testing.assert_allclose(fs_t.numpy(), np.asarray(fs_j), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(fw_t.numpy(), np.asarray(fw_j))
    np.testing.assert_allclose(ne_t.numpy(), np.asarray(ne_j), rtol=0, atol=1e-5)


def _quick_code8(v, scale):
    """``quant8.cu``'s quick_code8 in numpy f32: rint(v * rn(1 / scale))
    where that product lies farther than 3e-5 from a half-integer, else
    None (the kernel divides there)."""
    r = np.float32(1.0) / scale
    y = (v * r).astype(np.float32)
    k = np.rint(y)
    taken = (np.abs(np.abs(y - k) - np.float32(0.5)) > np.float32(3e-5)) & (r < 3e38)
    return np.clip(k, -127, 127), taken


@pytest.mark.parametrize("seed", range(4))
def test_quant8_quick_code_is_the_division_code_where_taken(seed):
    """The kernel's shortcut gives the IEEE division's code wherever it is
    taken, over a million values across scales, and declines near every
    half-integer code boundary."""
    rng = np.random.default_rng(seed)
    for amax in (np.float32(1.0), np.float32(127.0), np.float32(3.7e-3), np.float32(2.5e30)):
        scale = (amax * np.float32(1.0 / 127.0)).astype(np.float32)
        v = (rng.uniform(-1.0, 1.0, 250_000) * amax).astype(np.float32)
        want = np.clip(np.rint((v / scale).astype(np.float32)), -127, 127)
        got, taken = _quick_code8(v, scale)
        assert taken.mean() > 0.99
        np.testing.assert_array_equal(got[taken], want[taken])
        half = ((np.arange(-127, 127) + np.float32(0.5)) * scale).astype(np.float32)
        assert not _quick_code8(half, scale)[1].any()


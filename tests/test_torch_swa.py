"""Port parity for sliding-window decode attention, PyTorch vs JAX.

The same numpy-seeded inputs go through the reference
(``repro.kernels.ref.sliding_window_decode_attention_ref``, its oracle, and
``repro.kernels.ops.swa_decode_attention(use_pallas=True)``, the Pallas
kernel in interpret mode, both vmapped over the batch as
``tests/test_kernels.py`` drives them) and through the port on the CPU,
where ``kernels/ops.swa_decode_attention`` runs the plain version
(``kernels/ref.sliding_window_decode_attention_ref``) that the
``swa_decode`` CUDA kernel is held against on the card.

Tolerances.  f32 to ``atol=2e-5, rtol=1e-4``, the reference's own
kernel-vs-oracle tolerance (``tests/test_kernels.py``): the port scales q
before the dot product as the kernel does, the oracle scales the scores
after it, and the sums run in other orders.  bf16 outputs equal or one
bf16 ulp apart: both sides compute in f32 and round once at the end
(within f32's ``atol`` near zero, where the f32 rounding alone spans
bf16 ulps).  A row whose window is empty (``cache_len >= S + window``)
gives zeros in the port and in the Pallas kernel (the oracle gives NaN
there).

The kernel's host plan (``swa_attention.plan`` / ``split_ranges``, pure
functions of the shapes): every window position lies in exactly one
split, the main paths' shapes fill the card, and the split-and-merge
algorithm (numpy f64, the plan's splits and 32-position tiles) is the
plain function to the f32 tolerance, empty splits adding nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import one_intra_op_thread  # noqa: F401

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import swa_attention as tswa

F32_TOL = dict(atol=2e-5, rtol=1e-4)
SHAPES = [(8, 8, 64), (8, 2, 64), (4, 1, 128), (10, 1, 256)]   # (Hq, Hkv, d)
WINDOWS = [64, 256]
LENS = [300, 77, 40, 512]       # len > window, len > 64 > ..., len < window, len = S


def _inputs(b, hq, hkv, d, s, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, k, v


def _jax(q, k, v, lens, window, dtype=jnp.float32, **kw):
    fn = jax.vmap(lambda qq, kk, vv, ln: jops.swa_decode_attention(qq, kk, vv, ln, window, **kw))
    out = fn(jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
             jnp.asarray(lens, jnp.int32))
    return np.asarray(out.astype(jnp.float32))


def _port(q, k, v, lens, window, dtype=torch.float32):
    out = tops.swa_decode_attention(
        torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
        torch.from_numpy(v).to(dtype), torch.tensor(lens, dtype=torch.int32), window)
    assert out.dtype == dtype
    return out.to(torch.float32).numpy()


def _bf16_ulps(a, b):
    """Elementwise distance in bf16 ulps of two arrays of bf16 values held
    as f32."""
    def ordered(x):
        bits = torch.tensor(x).to(torch.bfloat16).view(torch.int16).to(torch.int32)
        mag = bits & 0x7FFF
        return torch.where(bits < 0, -mag, mag)
    return torch.abs(ordered(a) - ordered(b)).numpy()


def assert_bf16_close(got, want):
    """Equal or one bf16 ulp apart; near zero, where f32 rounding of the
    sums alone spans several bf16 ulps, within f32's ``atol`` instead."""
    ok = (_bf16_ulps(got, want) <= 1) | (np.abs(got - want) <= F32_TOL["atol"])
    assert ok.all(), (got[~ok], want[~ok])


@pytest.mark.parametrize("hq,hkv,d", SHAPES)
@pytest.mark.parametrize("window", WINDOWS)
def test_port_matches_oracle_and_pallas_f32(hq, hkv, d, window):
    q, k, v = _inputs(len(LENS), hq, hkv, d, 512, hq * d + window)
    got = _port(q, k, v, LENS, window)
    np.testing.assert_allclose(got, _jax(q, k, v, LENS, window), **F32_TOL)
    pallas = _jax(q, k, v, LENS, window, use_pallas=True, interpret=True)
    np.testing.assert_allclose(got, pallas, **F32_TOL)


@pytest.mark.parametrize("hq,hkv,d", SHAPES)
def test_port_matches_oracle_bf16_within_one_ulp(hq, hkv, d):
    q, k, v = _inputs(len(LENS), hq, hkv, d, 512, 7 * hq + d)
    got = _port(q, k, v, LENS, 64, torch.bfloat16)
    want = _jax(q, k, v, LENS, 64, jnp.bfloat16)
    assert_bf16_close(got, want)


@pytest.mark.parametrize("s,lens", [(200, [1, 63, 64, 65, 200]), (1000, [999, 1000, 130, 5, 64])])
@pytest.mark.parametrize("hq,hkv,d", [(10, 1, 256), (8, 2, 64)])
def test_port_matches_oracle_any_cache_length(s, lens, hq, hkv, d):
    """S not a multiple of the TPU kernel's 512 (oracle only: the Pallas
    kernel asserts s % 512 == 0)."""
    q, k, v = _inputs(len(lens), hq, hkv, d, s, s + d)
    np.testing.assert_allclose(_port(q, k, v, lens, 64), _jax(q, k, v, lens, 64), **F32_TOL)


@pytest.mark.parametrize("window", [64, 256])
def test_empty_window_gives_zeros_as_the_pallas_kernel(window):
    s = 512
    lens = [s + window, s + window + 100, 300]
    q, k, v = _inputs(3, 8, 2, 64, s, window)
    got = _port(q, k, v, lens, window)
    pallas = _jax(q, k, v, lens, window, use_pallas=True, interpret=True)
    assert np.all(got[:2] == 0.0) and np.all(pallas[:2] == 0.0)
    assert np.all(np.isnan(_jax(q, k, v, lens, window)[:2]))       # the oracle's NaN
    np.testing.assert_allclose(got[2], pallas[2], **F32_TOL)


def test_positions_outside_the_window_are_ignored_bitwise():
    q, k, v = _inputs(2, 4, 4, 32, 512, 9)
    lens, window = [300, 77], 64
    base = _port(q, k, v, lens, window)
    k2, v2 = k.copy(), v.copy()
    for row, n in enumerate(lens):
        lo = max(0, n - window)
        k2[row, :lo] += 100.0
        v2[row, :lo] -= 100.0
        k2[row, n:] *= -3.0
        v2[row, n:] = 1e6
    np.testing.assert_array_equal(_port(q, k2, v2, lens, window), base)


def test_ops_on_cpu_is_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 8, 2, 64, 96, 3))
    lens = torch.tensor([96, 10], dtype=torch.int32)
    torch.testing.assert_close(
        tops.swa_decode_attention(q, k, v, lens, 32),
        tref.sliding_window_decode_attention_ref(q, k, v, lens, 32), rtol=0, atol=0)


def test_wrapper_refuses_cpu_tensors_and_counts_work():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 8, 2, 64, 96, 3))
    lens = torch.tensor([96, 10], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tswa.swa_decode(q, k, v, lens, 32)
    bytes_, ops_ = tswa.swa_decode_work(q, k, lens, 32)
    positions = 32 + 10                   # row 0: [64, 96); row 1: [0, 10)
    assert bytes_ == positions * 2 * 64 * 2 * 4 + 2 * 2 * 8 * 64 * 4 + 2 * 4
    assert ops_ == positions * 8 * (4 * 64 + 6)


# --- the kernel's host plan (flash-decoding split) ---------------------------

PLAN_CASES = [   # (B, Hq, S, Hkv, window)
    (8, 10, 2233, 1, 2048),          # hybrid-window
    (8, 10, 321, 1, 2048),           # hybrid-serve
    (8, 32, 161, 8, 2 ** 30),        # dense-decode
    (6, 36, 2233, 2, 5),             # a window shorter than one tile, g = 18
    (1, 1, 1, 1, 1),
    (2, 16, 4096, 1, 64),
    (64, 64, 100, 64, 2048),         # more kv rows than the target
]


@pytest.mark.parametrize("b,hq,s,hkv,window", PLAN_CASES)
def test_every_window_position_lies_in_exactly_one_split(b, hq, s, hkv, window):
    splits, chunk = tswa.plan(b, hq, s, hkv, window)
    assert chunk % tswa.TILE == 0 and splits >= 1
    assert splits * chunk >= min(s, window) > (splits - 1) * chunk
    for length in sorted({1, 2, window - 1, window, window + 1, s - 1, s, s + 1,
                          s + window - 1, s + window, 3 * s} - {0}):
        ranges = tswa.split_ranges(length, s, window, splits, chunk)
        lo, hi = max(0, length - window), min(length, s)
        covered = [p for a, e in ranges for p in range(a, e)]
        assert covered == list(range(lo, hi)), length      # disjoint, in order, all of it
        assert all(e - a <= chunk for a, e in ranges)


def test_plan_fills_the_card_at_the_main_paths_shapes():
    rows = lambda b, hq, hkv: b * hkv * -(-(hq // hkv) // tswa.HEAD_CHUNK)  # noqa: E731
    assert tswa.plan(8, 10, 2233, 1, 2048) == (32, 64)       # 256 blocks of <= 64
    for case in PLAN_CASES[:3]:
        b, hq, s, hkv, window = case
        splits, chunk = tswa.plan(*case)
        tiles = -(-min(s, window) // tswa.TILE)
        # at least one block per SM unless every split is one tile; never
        # more than two blocks per SM
        assert rows(b, hq, hkv) * splits >= tswa.TARGET_BLOCKS // 2 or splits == tiles
        assert rows(b, hq, hkv) * splits <= tswa.TARGET_BLOCKS


def _split_merge(q, k, v, lens, window):
    """The kernel's algorithm in numpy (f64): each split's tiles of 32
    positions through the clipped online softmax, then the splits merged in
    order; the plan's split."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    splits, chunk = tswa.plan(b, hq, s, hkv, window)
    clip = lambda x: np.exp(np.clip(x, -80.0, 0.0))  # noqa: E731
    out = np.zeros((b, hq, d))
    for row in range(b):
        for h in range(hq):
            qs = q[row, h].astype(np.float64) * d ** -0.5
            parts = []
            for a, e in tswa.split_ranges(int(lens[row]), s, window, splits, chunk):
                m, l, acc = -1e30, 0.0, np.zeros(d)
                for t0 in range(a, e, tswa.TILE):
                    pos = np.arange(t0, min(e, t0 + tswa.TILE))
                    sc = k[row, pos, h // g] @ qs
                    m_new = max(m, sc.max())
                    p = clip(sc - m_new)
                    alpha = clip(m - m_new)
                    l, acc, m = l * alpha + p.sum(), acc * alpha + p @ v[row, pos, h // g], m_new
                parts.append((m, l, acc))
            mx = max(m for m, _, _ in parts)
            den = sum(l * clip(m - mx) for m, l, _ in parts)
            num = sum(acc * clip(m - mx) for m, _, acc in parts)
            out[row, h] = num / max(den, 1e-20)
    return out


@pytest.mark.parametrize("hq,hkv,d,s,window", [(10, 1, 64, 700, 300), (8, 2, 32, 161, 2 ** 30),
                                               (4, 4, 32, 90, 5)])
def test_split_and_merge_is_the_plain_function(hq, hkv, d, s, window):
    """Splits with no position add nothing; the all-empty row is zeros."""
    lens = [1, 5, window + 3, s, s - 40, s + window]
    q, k, v = _inputs(len(lens), hq, hkv, d, s, 21)
    want = _port(q, k, v, lens, window)
    got = _split_merge(q, k, v, lens, window)
    np.testing.assert_allclose(got, want, **F32_TOL)
    assert np.all(got[-1] == 0)

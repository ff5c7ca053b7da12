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
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

"""Port parity for the SSM family (mamba2), PyTorch vs JAX on the CPU at
REDUCED size, and the serving launcher and example on it.

``ssd_chunked``: y within ``1e-5`` of its largest and the final state to
``atol=1e-5`` (the port contracts the reference's three-operand einsums
two operands at a time, in another order).  ``_causal_conv``: f32 to
``rtol=1e-6``, bf16 bitwise before the activation.  The models to the
tolerances of ``torch_lm_parity``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import one_intra_op_thread  # noqa: F401

from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch.examples import serve_model
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import layers as tL
from repro_torch.models import ssm as tssm
from repro_torch.optim import sgd as tsgd
from torch_lm_parity import (assert_rel, batches, carry, cfgs, check_bf16_loss, check_decode,
                             check_forward_and_loss, check_init, check_prefill,
                             check_round_trip_bf16, check_train_step)

ARCH = "mamba2-2.7b"


def _ssd_inputs(nc, with_h0, q=16, b=2, h=3, p=8, n=5):
    rng = np.random.default_rng(10 * nc + with_h0)
    sl = nc * q
    x = rng.standard_normal((b, sl, h, p)).astype(np.float32)
    dt = (0.5 * rng.random((b, sl, h))).astype(np.float32)
    a = (-4.0 * rng.random(h)).astype(np.float32)
    bm = rng.standard_normal((b, sl, n)).astype(np.float32)
    cm = rng.standard_normal((b, sl, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, n, p)).astype(np.float32) if with_h0 else None
    return (x, dt, a, bm, cm), h0, q


@pytest.mark.parametrize("nc", [1, 2, 4])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(nc, with_h0):
    args, h0, q = _ssd_inputs(nc, with_h0)
    jy, jh = jax.jit(jssm.ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, args), q, None if h0 is None else jnp.asarray(h0))
    ty, th = tssm.ssd_chunked(*map(torch.from_numpy, args), q,
                              None if h0 is None else torch.from_numpy(h0))
    assert ty.shape == jy.shape and th.shape == jh.shape
    assert_rel(ty.numpy(), np.asarray(jy), 1e-5, "y")
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)


def test_ssd_chunked_is_the_sequential_recurrence():
    """h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T, y_t = C_t h_t, in f64."""
    args, h0, q = _ssd_inputs(2, True)
    x, dt, a, bm, cm = (a.astype(np.float64) for a in args)
    hs = h0.astype(np.float64)
    ys = []
    for t in range(x.shape[1]):
        hs = (np.exp(dt[:, t] * a)[:, :, None, None] * hs
              + np.einsum("bh,bn,bhp->bhnp", dt[:, t], bm[:, t], x[:, t]))
        ys.append(np.einsum("bn,bhnp->bhp", cm[:, t], hs))
    ty, th = tssm.ssd_chunked(*map(torch.from_numpy, args), q, torch.from_numpy(h0))
    assert_rel(ty.numpy(), np.stack(ys, 1), 1e-5, "y")
    np.testing.assert_allclose(th.numpy(), hs, atol=1e-5)


def test_ssd_chunked_refuses_a_partial_chunk():
    args, _, q = _ssd_inputs(2, False)
    x, dt, a, bm, cm = (torch.from_numpy(v[:, :-3] if v.ndim > 1 else v) for v in args)
    with pytest.raises(ValueError, match="not a multiple of the SSD chunk"):
        tssm.ssd_chunked(x, dt, a, bm, cm, q)
    _, tcfg, _, tp = carry(ARCH)
    with pytest.raises(ValueError, match="not a multiple of the SSD chunk"):
        tssm.forward(tp, {"tokens": torch.zeros((1, tcfg.ssm_chunk + 1), dtype=torch.int32)},
                     tcfg)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 ulps (sign-magnitude bits made ordered)."""
    def ordered(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32)
        mag = bits & 0x7FFF
        return torch.where(bits < 0, -mag, mag)
    return int(torch.max(torch.abs(ordered(a) - ordered(b))))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_causal_conv_matches_reference(dtype, monkeypatch):
    """The taps add from zero in the reference's order in the model dtype:
    in bf16 the sum before the activation is bitwise the reference's (both
    activations replaced by the identity; f32 to ``rtol=1e-6``).  After
    the SiLU, f32 to
    ``rtol=1e-6``; bf16 within 2 ulps (XLA's bf16 logistic rounds at other
    places than PyTorch's, which rounds once: measured 2)."""
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 21, 40)), jd)
    w = jnp.asarray(rng.standard_normal((4, 40)) / 2, jd)
    b = jnp.asarray(rng.standard_normal(40) / 4, jd)
    args = [tL.tensor_from_array(np.asarray(v), "cpu") for v in (x, w, b)]
    want = tL.tensor_from_array(np.asarray(jax.jit(jssm._causal_conv)(x, w, b)), "cpu")
    got = tssm._causal_conv(*args)
    assert got.dtype == td and got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    else:
        assert _ulps(got, want) <= 2
    monkeypatch.setattr(jax.nn, "silu", lambda v: v)
    monkeypatch.setattr(tssm.F, "silu", lambda v: v)
    pre = jax.jit(lambda *a: jssm._causal_conv(*a))(x, w, b)     # traced anew
    pre = tL.tensor_from_array(np.asarray(pre), "cpu")
    if dtype == "bf16":
        assert torch.equal(tssm._causal_conv(*args), pre)
    else:   # XLA may contract the f32 taps into fused multiply-adds
        np.testing.assert_allclose(tssm._causal_conv(*args).numpy(), pre.numpy(), rtol=1e-6,
                                   atol=1e-6)


# --- whole model ---------------------------------------------------------------------

def test_forward_and_loss_match_reference():
    check_forward_and_loss(ARCH)


def test_bf16_loss_matches_reference():
    check_bf16_loss(ARCH)


def test_train_step_matches_reference():
    check_train_step(ARCH)


def test_prefill_step_is_the_last_row_of_forward():
    check_prefill(ARCH)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_teacher_forced_matches_reference(dtype):
    """48 steps, batch 2: logits, the f32 SSM state, the conv state and the
    length at every step."""
    check_decode(ARCH, dtype, 48)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_init_matches_reference_shapes_and_dtypes(dtype):
    check_init(ARCH, dtype)


def test_from_numpy_to_numpy_round_trip_bf16():
    check_round_trip_bf16(ARCH)


def test_bf16_train_step_keeps_the_f32_leaves():
    """``a_log``, ``d_skip`` and ``dt_bias`` stay f32 in a bf16 model through
    ``from_numpy`` and a train step."""
    jcfg, tcfg, _, tp = carry(ARCH, "bf16")
    _, tb = batches(jcfg, s=16)
    new, loss = tapi.make_train_step(tcfg)(tp, tb)
    for leaves in (tp.blocks, new.blocks):
        assert {f: getattr(leaves, f).dtype for f in ("a_log", "d_skip", "dt_bias")} == dict.fromkeys(
            ("a_log", "d_skip", "dt_bias"), torch.float32)
        assert leaves.in_proj.dtype == torch.bfloat16
    assert [t.dtype for t in tsgd.tree_leaves(new)] == [t.dtype for t in tsgd.tree_leaves(tp)]
    assert bool(torch.isfinite(loss))


def test_cache_is_constant_in_max_seq():
    _, tcfg = cfgs(ARCH)
    small, large = (tapi.init_cache(tcfg, 2, s, device="cpu") for s in (8, 4096))
    assert [t.shape for t in tL.leaves(small)] == [t.shape for t in tL.leaves(large)]
    d_in, h, p, n = tssm.dims(tcfg)
    assert small.ssm_state.shape == (tcfg.n_layers, 2, h, n, p)
    assert small.ssm_state.dtype == torch.float32 and small.length.dtype == torch.int32


def test_decode_gives_forward_logits_at_every_position():
    """f32: the token-stepped decode's logits equal the full-sequence
    forward's (through the tied embedding) at every position, within 1e-4
    of the largest: the chunked scan and the recurrence are one model."""
    jcfg, tcfg, _, tp = carry(ARCH)
    toks = batches(jcfg, s=32, seed=4)[1]["tokens"]
    with torch.no_grad():
        want = tssm.forward(tp, {"tokens": toks}, tcfg) @ tp.embed.T
    cache = tapi.init_cache(tcfg, 2, 40, device="cpu")
    step = tapi.make_serve_step(tcfg)
    for t in range(toks.shape[1]):
        cache, logits = step(tp, cache, toks[:, t:t + 1])
        assert_rel(logits[:, 0].numpy(), want[:, t].numpy(), 1e-4, f"position {t}")


# --- the launcher and the example -------------------------------------------------

def test_serve_main_on_cpu(capsys):
    out = tserve.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "8",
                       "--new-tokens", "4"], device="cpu")
    assert out["device"] == "cpu" and len(out["sample_output"]) == 4
    assert all(0 <= t < tconfigs.get(ARCH, reduced=True).vocab_size for t in out["sample_output"])
    assert '"arch"' in capsys.readouterr().out


def test_serve_model_example_on_cpu(capsys):
    """``python -m repro_torch.examples.serve_model``: the reference
    example's default arch (mamba2-2.7b), batch 4, 16 + 8 tokens."""
    out = serve_model.main(["--device", "cpu"])
    assert out["arch"] == ARCH and out["device"] == "cpu" and out["batch"] == 4
    assert out["tok_per_s"] > 0 and len(out["sample_output"]) == 8
    assert all(0 <= t < tconfigs.get(ARCH, reduced=True).vocab_size for t in out["sample_output"])
    assert '"tok_per_s"' in capsys.readouterr().out

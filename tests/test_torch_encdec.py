"""Port parity for the enc-dec family (whisper), PyTorch vs JAX on the CPU
at REDUCED size, the layers it adds, and the launchers on it.

``sinusoidal_positions`` to ``atol=2e-6`` at 64 frames (sin and cos of
angles up to 63 rad in two libms; ``atol=2e-4`` at whisper's 1,500),
``layer_norm`` and ``gelu_mlp`` to ``rtol=1e-5, atol=1e-6``, the encoder
within ``1e-4`` of its largest output.  The models to the tolerances of
``torch_lm_parity``.  The invariant: teacher-forced decode with the cross
K/V of ``precompute_cross_kv`` gives ``forward``'s logits at every
position, within ``1e-3`` of the largest (f32), on the reference and on
the port.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import one_intra_op_thread  # noqa: F401

from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import layers as jL
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as tL
from torch_lm_parity import (assert_rel, batches, carry, check_bf16_loss, check_decode,
                             check_forward_and_loss, check_init, check_prefill,
                             check_round_trip_bf16, check_train_step, np32, t2np)

ARCH = "whisper-medium"


# --- layers ---------------------------------------------------------------------------

@pytest.mark.parametrize("length,dim,atol", [(1, 8, 0.0), (64, 256, 2e-6), (1500, 1024, 2e-4)])
def test_sinusoidal_positions_match_reference(length, dim, atol):
    want = np.asarray(jL.sinusoidal_positions(length, dim))
    got = tL.sinusoidal_positions(length, dim)
    assert got.dtype == torch.float32 and got.shape == (length, dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    np.testing.assert_array_equal(got[0].numpy(), np.tile([0.0, 1.0], dim // 2))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layer_norm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    x, s, b = (jnp.asarray(v, jd) for v in (3 + 2 * rng.standard_normal((3, 5, 48)),
                                           rng.standard_normal(48), rng.standard_normal(48)))
    want = jax.jit(jL.layer_norm)(x, s, b)
    got = tL.layer_norm(*(tL.tensor_from_array(np.asarray(v), "cpu") for v in (x, s, b)))
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    else:
        assert_rel(t2np(got), np32(want), 1e-2, "bf16 layer_norm")


def test_gelu_mlp_matches_reference():
    rng = np.random.default_rng(2)
    args = [rng.standard_normal(s).astype(np.float32) / 4
            for s in ((2, 7, 32), (32, 64), (64,), (64, 32), (32,))]
    want = jax.jit(jL.gelu_mlp)(*map(jnp.asarray, args))
    got = tL.gelu_mlp(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("heads,kv,t,qk_norm", [(4, 4, 24, False), (4, 2, 17, False),
                                                 (4, 1, 9, True)])
def test_full_attention_cross_kv_matches_reference(heads, kv, t, qk_norm):
    """q alone projected (q-norm when there is one), k and v as given, no
    rope, no causal or window mask even when asked for."""
    b, s, d_model, hd = 2, 6, 48, 16
    jp = jattn.init(jax.random.key(5), d_model, heads, kv, hd, qk_norm, jnp.float32)
    if qk_norm:
        jp = jp._replace(q_norm=jnp.linspace(-0.5, 0.5, hd))
    tp = tattn.AttnParams(*(None if a is None else tL.tensor_from_array(np.asarray(a), "cpu")
                            for a in jp))
    rng = np.random.default_rng(t)
    x = rng.standard_normal((b, s, d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((b, t, kv, hd)).astype(np.float32) for _ in range(2))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    want = jax.jit(lambda *a: jattn.full_attention(
        jp, a[0], a[1], window=2, rope_theta=10000.0, cross_kv=(a[2], a[3]), causal=True))(
        *map(jnp.asarray, (x, pos, ck, cv)))
    got = tattn.full_attention(tp, *map(torch.from_numpy, (x, pos)), window=2, rope_theta=10000.0,
                               cross_kv=(torch.from_numpy(ck), torch.from_numpy(cv)), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# --- the model -------------------------------------------------------------------------

def test_encode_matches_reference():
    jcfg, tcfg, jp, tp = carry(ARCH)
    jb, tb = batches(jcfg)
    want = jax.jit(lambda p, a: jencdec.encode(p, a, jcfg))(jp, jb["audio_embeds"])
    got = tencdec.encode(tp, tb["audio_embeds"], tcfg)
    assert got.shape == (2, jcfg.n_audio_frames, jcfg.d_model)
    assert_rel(t2np(got), np32(want), 1e-4, "encoder output")


def test_forward_and_loss_match_reference():
    check_forward_and_loss(ARCH)


def test_bf16_loss_matches_reference():
    check_bf16_loss(ARCH)


def test_train_step_with_audio_matches_reference():
    check_train_step(ARCH)


def test_prefill_step_is_the_last_row_of_forward():
    check_prefill(ARCH)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_with_zero_cross_kv_matches_reference(dtype):
    """``init_cache``'s cross K/V are zeros, as the reference's: 40 steps."""
    check_decode(ARCH, dtype, 40)


def _port_cross_kv(dtype):
    jcfg, tcfg, _, tp = carry(ARCH, dtype)
    _, tb = batches(jcfg)
    with torch.no_grad():
        return tencdec.precompute_cross_kv(tp, tencdec.encode(tp, tb["audio_embeds"], tcfg), tcfg)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_after_precompute_cross_kv_matches_reference(dtype):
    """Each side's cross K/V from its own encoder over the same audio, 40
    steps; the cache's cross K/V leaves are held too."""
    check_decode(ARCH, dtype, 40, cross_kv=_port_cross_kv(dtype))


def test_precompute_cross_kv_is_each_layers_projection():
    _, tcfg, _, tp = carry(ARCH)
    enc = torch.randn((2, 5, tcfg.d_model), generator=torch.Generator().manual_seed(0))
    ck, cv = tencdec.precompute_cross_kv(tp, enc, tcfg)
    assert ck.shape == (tcfg.n_layers, 2, 5, tcfg.n_kv_heads, tcfg.head_dim)
    for i in range(tcfg.n_layers):
        a = tL.layer_slice(tp.dec_blocks, i).cross_attn
        torch.testing.assert_close(ck[i], torch.einsum("btd,dhk->bthk", enc, a.wk))
        torch.testing.assert_close(cv[i], torch.einsum("btd,dhk->bthk", enc, a.wv))


@functools.lru_cache(maxsize=None)
def _ref_invariant():
    """The reference's worst position: max |decode logit - forward logit| /
    max |forward logit| over 24 positions."""
    jcfg, _, jp, _ = carry(ARCH)
    jb, _ = batches(jcfg, s=24, seed=6)
    want = jax.jit(lambda p, b: jencdec.forward(p, b, jcfg) @ p.embed.T)(jp, jb)
    enc = jencdec.encode(jp, jb["audio_embeds"], jcfg)
    ck, cv = jencdec.precompute_cross_kv(jp, enc, jcfg)
    cache = japi.init_cache(jcfg, 2, 32)._replace(cross_k=ck, cross_v=cv)
    step = jax.jit(japi.make_serve_step(jcfg))
    worst = 0.0
    for t in range(24):
        cache, logits = step(jp, cache, jb["tokens"][:, t:t + 1])
        w = np.asarray(want[:, t])
        worst = max(worst, float(np.abs(np.asarray(logits[:, 0]) - w).max() / np.abs(w).max()))
    return worst


@pytest.mark.parametrize("side", ["reference", "port"])
def test_decode_after_precompute_gives_forward_logits(side):
    """Teacher-forced decode from ``precompute_cross_kv``'s cache gives the
    full-sequence forward's logits at every position (f32, 1e-3 of the
    largest), on the reference and on the port."""
    if side == "reference":
        assert _ref_invariant() <= 1e-3
        return
    jcfg, tcfg, _, tp = carry(ARCH)
    _, tb = batches(jcfg, s=24, seed=6)
    with torch.no_grad():
        want = tencdec.forward(tp, tb, tcfg) @ tp.embed.T
        ck, cv = tencdec.precompute_cross_kv(
            tp, tencdec.encode(tp, tb["audio_embeds"], tcfg), tcfg)
    cache = tapi.init_cache(tcfg, 2, 32, device="cpu")._replace(cross_k=ck, cross_v=cv)
    step = tapi.make_serve_step(tcfg)
    for t in range(24):
        cache, logits = step(tp, cache, tb["tokens"][:, t:t + 1])
        assert_rel(logits[:, 0].numpy(), want[:, t].numpy(), 1e-3, f"position {t}")


def test_step_position_is_the_table_row():
    for step in (0, 1, 17, 447):
        got = tencdec.step_position(torch.tensor(step, dtype=torch.int32), 256)
        np.testing.assert_allclose(got.numpy(), tL.sinusoidal_positions(448, 256)[step].numpy(),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_init_matches_reference_shapes_and_dtypes(dtype):
    check_init(ARCH, dtype)


def test_from_numpy_to_numpy_round_trip_bf16():
    check_round_trip_bf16(ARCH)


# --- the launchers ----------------------------------------------------------------------

def test_serve_main_on_cpu(capsys):
    out = tserve.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "8",
                       "--new-tokens", "4"], device="cpu")
    assert out["device"] == "cpu" and len(out["sample_output"]) == 4
    assert all(0 <= t < tconfigs.get(ARCH, reduced=True).vocab_size for t in out["sample_output"])
    assert '"arch"' in capsys.readouterr().out


def test_train_production_draws_audio_on_cpu(monkeypatch):
    """``launch/train`` production for whisper: each batch carries
    ``audio_embeds`` (batch, n_audio_frames, d) in the model dtype, drawn
    from the run's generator after the tokens."""
    seen, plain = [], tapi.make_train_step

    def recording(cfg, data=None):
        step = plain(cfg, data)

        def run(params, batch):
            seen.append({k: (tuple(v.shape), v.dtype) for k, v in batch.items()})
            return step(params, batch)
        return run

    monkeypatch.setattr(ttrain.api, "make_train_step", recording)
    out = ttrain.main(["production", "--arch", ARCH, "--steps", "2", "--batch", "2",
                       "--seq", "16"], device="cpu")
    cfg = tconfigs.get(ARCH, reduced=True)
    assert out["finite"] and out["tokens_per_s"] > 0 and len(seen) == 2
    assert seen[0] == {"tokens": ((2, 16), torch.int32),
                       "audio_embeds": ((2, cfg.n_audio_frames, cfg.d_model), cfg.dtype)}

"""Port parity for language-model training and the full-sequence forward,
PyTorch vs JAX, on the CPU.

The reference's own params (``repro.models.api.init_params``) are carried
into the port by ``from_numpy``; inputs come from numpy generators with
fixed seeds.  f32 unless stated.  Tolerances:
- ``chunked_cross_entropy``: ``rtol=1e-6`` (one f32 logsumexp per row, the
  chunk sums in the same order).
- ``full_attention``: ``atol=1e-5``.
- ``_rglru_scan``: ``rtol=1e-5, atol=1e-6``; the port's log-depth scan
  associates in another order than ``jax.lax.associative_scan``.
- ``forward``: hidden states within ``1e-4 * max|h|``; ``loss`` to
  ``rtol=1e-5``; bf16 loss within ``2e-2`` relative.
- One ``make_train_step``: every leaf's update (new - old) within ``1e-4``
  of the largest update coordinate, at lr 1e-2 (the reference's pod
  tests' rate).  The f32 params round the new value to one ulp of |p|,
  which at the configs' lr 3e-4 is ~4e-4 of the largest update on either
  side (measured), so that rate measures the rounding, not the step; the
  gradients themselves are held at lr-free ``1e-4`` of their largest.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import one_intra_op_thread  # noqa: F401

from repro import configs as jconfigs
from repro.checkpoint import store as jstore
from repro.core import compression as jcomp
from repro.launch import experiment as jexp
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import layers as jL
from repro.models import rglru as jrglru
from repro.optim.sgd import local_sgd as jlocal_sgd
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import CheckpointStore
from repro_torch.checkpoint.store import _flatten, load_pytree
from repro_torch.core import compression as tcomp
from repro_torch.data.pipeline import lm_batches
from repro_torch.data.synthetic import SyntheticConfig, generate, normalize
from repro_torch.launch import experiment as texp
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models import autoencoder as tae
from repro_torch.models import layers as tL
from repro_torch.models import encdec, moe, rglru, ssm, transformer
from repro_torch.optim import sgd as tsgd

ARCHS = {"recurrentgemma-2b": rglru, "llama3-8b": transformer, "gemma2-27b": transformer,
         "internvl2-26b": transformer}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(arch, dtype="f32", **kw):
    jd, td = DTYPES[dtype]
    return (jconfigs.get(arch, reduced=True).replace(dtype=jd, **kw),
            tconfigs.get(arch, reduced=True).replace(dtype=td, **kw))


def _carry(arch, jcfg):
    jp = japi.init_params(jax.random.key(0), jcfg)
    return jp, ARCHS[arch].from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _batches(jcfg, b=2, s=40, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if jcfg.n_visual_tokens:
        vis = rng.standard_normal((b, jcfg.n_visual_tokens, jcfg.d_model)).astype(np.float32)
        jb["visual_embeds"] = jnp.asarray(vis, jcfg.dtype)
        tb["visual_embeds"] = tL.tensor_from_array(np.asarray(jb["visual_embeds"]), "cpu")
    return jb, tb


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t2np(t):
    return t.detach().to(torch.float32).numpy()


# --- layers ------------------------------------------------------------------

@pytest.mark.parametrize("tokens,n_chunks,cap", [
    (32, 1, None), (32, 4, None), (32, 4, 30.0), (30, 4, 30.0), (30, 1, None),
])
def test_chunked_cross_entropy_matches_reference(tokens, n_chunks, cap):
    """A mask with zeros, 1 and 4 chunks, soft-capped or not; 30 tokens do
    not split into 4 chunks, so both sides fall back to one."""
    rng = np.random.default_rng(tokens + n_chunks)
    h = rng.standard_normal((tokens, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 97)) * 2).astype(np.float32)
    t = rng.integers(0, 97, tokens).astype(np.int32)
    m = (rng.random(tokens) > 0.3).astype(np.float32)
    want = jax.jit(lambda *a: jL.chunked_cross_entropy(*a, n_chunks=n_chunks,
                                                       softcap_value=cap))(
        *map(jnp.asarray, (h, w, t, m)))
    got = tL.chunked_cross_entropy(*map(torch.from_numpy, (h, w, t, m)), n_chunks=n_chunks,
                                   softcap_value=cap)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_chunked_cross_entropy_empty_mask_divides_by_one():
    h, w = torch.ones((8, 4)), torch.ones((4, 5))
    t, m = torch.zeros(8, dtype=torch.int32), torch.zeros(8)
    assert float(tL.chunked_cross_entropy(h, w, t, m, n_chunks=2)) == 0.0


def test_chunked_cross_entropy_gradient_matches_reference():
    rng = np.random.default_rng(9)
    h = rng.standard_normal((24, 16)).astype(np.float32)
    w = rng.standard_normal((16, 33)).astype(np.float32)
    t = rng.integers(0, 33, 24).astype(np.int32)
    m = np.ones(24, np.float32)
    want = jax.jit(jax.grad(lambda hh, ww: jL.chunked_cross_entropy(
        hh, ww, jnp.asarray(t), jnp.asarray(m), n_chunks=3, softcap_value=5.0),
        argnums=(0, 1)))(jnp.asarray(h), jnp.asarray(w))
    ht, wt = (torch.from_numpy(x).requires_grad_(True) for x in (h, w))
    tL.chunked_cross_entropy(ht, wt, torch.from_numpy(t), torch.from_numpy(m), n_chunks=3,
                             softcap_value=5.0).backward()
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("heads,kv,hd,window,cap,causal", [
    (4, 4, 16, None, None, True),     # MHA, causal
    (4, 2, 32, None, None, True),     # GQA
    (4, 2, 32, 8, None, True),        # sliding window
    (4, 1, 32, 8, 50.0, True),        # MQA, window, soft-capped
    (4, 2, 16, 2 ** 30, None, True),  # a "global" layer's window
    (4, 2, 16, None, None, False),    # not causal
])
def test_full_attention_matches_reference(heads, kv, hd, window, cap, causal):
    b, s, d_model = 2, 24, 48
    jp = jattn.init(jax.random.key(3), d_model, heads, kv, hd, False, jnp.float32)
    tp = tattn.AttnParams(*(None if a is None else tL.tensor_from_array(np.asarray(a), "cpu")
                            for a in jp))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, s, d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    want = jax.jit(lambda xx, pp: jattn.full_attention(
        jp, xx, pp, window=window, attn_softcap=cap, causal=causal))(jnp.asarray(x),
                                                                     jnp.asarray(pos))
    got = tattn.full_attention(tp, torch.from_numpy(x), torch.from_numpy(pos), window=window,
                               attn_softcap=cap, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_full_attention_cross_kv_raises():
    """The enc-dec cross-attention branch, once a ``NotImplementedError``,
    against the reference: q alone projected, k and v as given (GQA, 4 kv
    positions), no mask even with ``causal`` and a window."""
    jp = jattn.init(jax.random.key(0), 16, 2, 1, 8, False, jnp.float32)
    tp = tattn.AttnParams(*(None if a is None else tL.tensor_from_array(np.asarray(a), "cpu")
                            for a in jp))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, 4, 1, 8)).astype(np.float32) for _ in range(2))
    pos = np.arange(4, dtype=np.int32)[None]
    want = jax.jit(lambda *a: jattn.full_attention(jp, a[0], a[1], window=1,
                                                   cross_kv=(a[2], a[3])))(
        *map(jnp.asarray, (x, pos, k, v)))
    got = tattn.full_attention(tp, torch.from_numpy(x), torch.from_numpy(pos), window=1,
                               cross_kv=(torch.from_numpy(k), torch.from_numpy(v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("length", [1, 2, 37, 64, 100])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_reference(length, with_h0):
    rng = np.random.default_rng(length)
    a = rng.uniform(0.5, 0.999, (2, length, 24)).astype(np.float32)
    bx = rng.standard_normal((2, length, 24)).astype(np.float32)
    h0 = rng.standard_normal((2, 24)).astype(np.float32) if with_h0 else None
    want_h, want_last = jax.jit(jrglru._rglru_scan)(jnp.asarray(a), jnp.asarray(bx),
                                                    None if h0 is None else jnp.asarray(h0))
    got_h, got_last = rglru._rglru_scan(torch.from_numpy(a), torch.from_numpy(bx),
                                        None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last), rtol=1e-5, atol=1e-6)


def test_rglru_scan_is_the_sequential_recurrence():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(0.1, 1.0, (1, 19, 6)).astype(np.float64))
    bx = torch.from_numpy(rng.standard_normal((1, 19, 6)))
    h0 = torch.from_numpy(rng.standard_normal((1, 6)))
    got, last = rglru._rglru_scan(a, bx, h0)
    h = h0[0]
    for t in range(19):
        h = a[0, t] * h + bx[0, t]
        torch.testing.assert_close(got[0, t], h, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(last[0], h, rtol=1e-12, atol=1e-12)


# --- whole models ------------------------------------------------------------

def _assert_rel(got, want, tol, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(np.asarray(got, np.float32) - want)))
    assert err <= tol * scale, f"{what}: max |diff| {err:.3e} > {tol} * {scale:.3e}"


@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_and_loss_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _carry(arch, jcfg)
    jb, tb = _batches(jcfg)
    jmod = japi.module(jcfg)
    want_h = jax.jit(lambda p, b: jmod.forward(p, b, jcfg))(jp, jb)
    got_h = ARCHS[arch].forward(tp, tb, tcfg)
    assert got_h.shape == want_h.shape and got_h.dtype == torch.float32
    _assert_rel(_t2np(got_h), _np(want_h), 1e-4, "hidden")
    want = float(jax.jit(japi.loss_fn(jcfg))(jp, jb))
    got = tapi.loss_fn(tcfg)(tp, tb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_bf16_loss_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch, "bf16")
    jp, tp = _carry(arch, jcfg)
    jb, tb = _batches(jcfg, seed=1)
    want = float(jax.jit(japi.loss_fn(jcfg))(jp, jb))
    got = float(tapi.loss_fn(tcfg)(tp, tb))
    assert abs(got - want) <= 2e-2 * abs(want)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "llama3-8b"])
def test_remat_changes_nothing(arch):
    """``cfg.remat`` recomputes the blocks in the backward pass: the loss
    and the gradients are bitwise those without it."""
    _, tcfg = _cfgs(arch)
    params = tapi.init_params(torch.Generator().manual_seed(0), tcfg)
    batch = {"tokens": torch.randint(0, tcfg.vocab_size, (2, 24),
                                     generator=torch.Generator().manual_seed(1))}
    outs = [tsgd.grad_and_value(tapi.loss_fn(tcfg.replace(remat=r)))(params, batch)
            for r in (True, False)]
    assert torch.equal(outs[0][1], outs[1][1])
    for a, b in zip(tsgd.tree_leaves(outs[0][0]), tsgd.tree_leaves(outs[1][0])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_step_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch, learning_rate=1e-2)
    jp, tp = _carry(arch, jcfg)
    jb, tb = _batches(jcfg, seed=2)
    jloss, jgrads = jax.jit(jax.value_and_grad(japi.loss_fn(jcfg)))(jp, jb)
    tgrads, tloss = tsgd.grad_and_value(tapi.loss_fn(tcfg))(tp, tb)
    jg = [np.asarray(g) for g in jax.tree.leaves(jgrads)]
    tg = [_t2np(g) for g in tsgd.tree_leaves(tgrads)]
    assert [g.shape for g in jg] == [g.shape for g in tg]
    gmax = max(float(np.abs(g).max()) for g in jg)
    for w, g in zip(jg, tg):
        assert float(np.abs(w - g).max()) <= 1e-4 * gmax
    jp2, jl = jax.jit(japi.make_train_step(jcfg))(jp, jb)
    tp2, tl = tapi.make_train_step(tcfg)(tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert type(tp2) is type(tp)
    want = [np.asarray(a) - np.asarray(b) for a, b in zip(jax.tree.leaves(jp2),
                                                          jax.tree.leaves(jp))]
    got = [_t2np(a) - _t2np(b) for a, b in zip(tsgd.tree_leaves(tp2), tsgd.tree_leaves(tp))]
    umax = max(float(np.abs(u).max()) for u in want)
    for w, g in zip(want, got):
        assert float(np.abs(w - g).max()) <= 1e-4 * umax


def test_train_step_bf16_update_is_the_reference_formula():
    """bf16 leaves: ``(p.f32 - lr * g.f32).to(bf16)`` of the port's own
    gradient, bitwise; the given params are left as they were."""
    _, tcfg = _cfgs("llama3-8b", "bf16")
    params = tapi.init_params(torch.Generator().manual_seed(0), tcfg)
    before = [p.clone() for p in tsgd.tree_leaves(params)]
    batch = {"tokens": torch.randint(0, tcfg.vocab_size, (2, 16),
                                     generator=torch.Generator().manual_seed(1))}
    grads, _ = tsgd.grad_and_value(tapi.loss_fn(tcfg))(params, batch)
    new, _ = tapi.make_train_step(tcfg)(params, batch)
    for p, g, n, b in zip(tsgd.tree_leaves(params), tsgd.tree_leaves(grads),
                          tsgd.tree_leaves(new), before):
        assert torch.equal(p, b) and n.dtype == torch.bfloat16
        want = (p.float() - tcfg.learning_rate * g.float()).to(torch.bfloat16)
        assert torch.equal(n, want)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_step_is_the_last_row_of_forward(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _carry(arch, jcfg)
    jb, tb = _batches(jcfg, s=20, seed=3)
    got = tapi.make_prefill_step(tcfg)(tp, tb)
    assert got.shape == (2, tcfg.d_model) and not got.requires_grad
    assert torch.equal(got, ARCHS[arch].forward(tp, tb, tcfg)[:, -1, :])
    _assert_rel(_t2np(got), _np(jax.jit(japi.make_prefill_step(jcfg))(jp, jb)), 1e-4,
                "prefill")


# --- local_sgd's autograd route -------------------------------------------------

def test_local_sgd_autograd_route_matches_reference():
    """A remat LM loss through ``local_sgd`` (gradients by
    ``torch.autograd.grad``) against ``repro.optim.sgd.local_sgd`` over the
    same batches."""
    jcfg, tcfg = _cfgs("llama3-8b", learning_rate=1e-2)
    jp, tp = _carry("llama3-8b", jcfg)
    jb, tb = _batches(jcfg, seed=4)
    j1, jl = jax.jit(lambda p, b: jlocal_sgd(japi.loss_fn(jcfg), p, b, 1e-2))(
        jp, jax.tree.map(lambda x: jnp.stack([x, x]), jb))
    t1, tl = tsgd.local_sgd(tapi.loss_fn(tcfg), tp, [tb, tb], 1e-2)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for w, g in zip(jax.tree.leaves(j1), tsgd.tree_leaves(t1)):
        np.testing.assert_allclose(_t2np(g), np.asarray(w), atol=1e-5)


def test_local_sgd_autograd_route_equals_torch_func_on_the_autoencoder():
    """``local_sgd``'s autograd gradients give the autoencoder the bits
    of a ``torch.func.grad_and_value`` loop."""
    g = torch.Generator().manual_seed(0)
    params = tae.init(g, 32, (16, 8, 16), device="cpu")
    batches = torch.randn((3, 8, 32), generator=g)
    want, losses = params, []
    for batch in batches:
        grads, loss = torch.func.grad_and_value(tae.loss)(want, batch)
        want = tsgd.sgd(want, grads, 0.05)
        losses.append(loss)
    got, gl = tsgd.local_sgd(tae.loss, params, batches, 0.05)
    assert torch.equal(gl, torch.mean(torch.stack(losses)))
    for a, b in zip(tsgd.tree_leaves(got), tsgd.tree_leaves(want)):
        assert torch.equal(a, b)


# --- data, compression ratio, checkpoints ------------------------------------------

def test_lm_batches_are_windows_of_the_stream():
    stream = torch.arange(100, dtype=torch.int32) * 3
    out = lm_batches(torch.Generator().manual_seed(0), stream, 5, 16)
    assert out.shape == (5, 17) and out.dtype == torch.int32
    starts = out[:, 0] // 3
    assert torch.all((starts >= 0) & (starts < 100 - 16 - 1))
    assert torch.equal(out, stream[starts[:, None].long() + torch.arange(17)])


@pytest.mark.parametrize("d", [1352, 1_443_072, 8_030_261_248])
@pytest.mark.parametrize("rho_s,bits", [(0.05, 8), (1.0, 8), (0.01, 32)])
def test_compression_ratio_matches_reference(d, rho_s, bits):
    tc = tcomp.CompressorConfig(rho_s=rho_s, quant_bits=bits, mode="blockwise")
    jc = jcomp.CompressorConfig(rho_s=rho_s, quant_bits=bits, mode="blockwise")
    assert tcomp.compression_ratio(d, tc) == pytest.approx(jcomp.compression_ratio(d, jc),
                                                           rel=1e-12)


CKPT_ARCHS = {**ARCHS, "qwen2-moe-a2.7b": moe, "grok-1-314b": moe, "mamba2-2.7b": ssm,
              "whisper-medium": encdec, "qwen3-14b": transformer}


@pytest.mark.parametrize("arch", list(CKPT_ARCHS))
def test_checkpoint_keys_are_the_reference_keystr(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = japi.init_params(jax.random.key(0), jcfg)
    keys = {jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert set(_flatten(tapi.init_params(torch.Generator().manual_seed(0), tcfg))) == keys


def test_checkpoint_round_trips_bf16_params_bitwise(tmp_path):
    cfg = tconfigs.get("recurrentgemma-2b", reduced=True)
    params = tapi.init_params(torch.Generator().manual_seed(0), cfg)
    store = CheckpointStore(str(tmp_path))
    store.save(3, params)
    like = tapi.init_params(torch.Generator().manual_seed(1), cfg)
    back, step = store.restore(like)
    assert step == 3 and type(back) is type(params)
    for a, b in zip(tsgd.tree_leaves(back), tsgd.tree_leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", list(CKPT_ARCHS))
def test_bf16_checkpoints_cross_between_the_packages_bitwise(tmp_path, arch):
    """``repro.checkpoint.load_pytree`` reads a port-written bf16 round
    as it reads its own save of the same params (2-byte voids, the same
    bytes), and the port reads the reference's round back into bf16
    leaves, bit for bit."""
    jcfg, tcfg = _cfgs(arch, "bf16")
    jp = japi.init_params(jax.random.key(0), jcfg)
    tp = CKPT_ARCHS[arch].from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    port_path = CheckpointStore(str(tmp_path / "port")).save(1, tp)
    ref_path = str(tmp_path / "ref.npz")
    jstore.save_pytree(ref_path, jp)
    got, want = jstore.load_pytree(port_path, jp), jstore.load_pytree(ref_path, jp)
    bits = [t.view(torch.uint8).numpy().tobytes() for t in tsgd.tree_leaves(tp)]
    assert len(jax.tree.leaves(got)) == len(bits)
    for g, w, b in zip(jax.tree.leaves(got), jax.tree.leaves(want), bits):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes() == b
    assert any(t.dtype == torch.bfloat16 for t in tsgd.tree_leaves(tp))
    back = load_pytree(ref_path, tapi.init_params(torch.Generator().manual_seed(1), tcfg))
    for a, b in zip(tsgd.tree_leaves(back), tsgd.tree_leaves(tp)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# --- the launcher --------------------------------------------------------------

def test_train_federated_equals_run_method(capsys):
    out = ttrain.main(["federated", "--sensors", "12", "--fog", "3", "--rounds", "2",
                       "--local-epochs", "1", "--seed", "1"], device="cpu")
    cfg = texp.make_config(n_sensors=12, n_fog=3, rounds=2, local_epochs=1, lr=0.01)
    ds = normalize(generate(torch.Generator().manual_seed(1), SyntheticConfig(n_sensors=12),
                            device="cpu"))
    res = texp.run_method("hfl-selective", ds, cfg, seed=1, device="cpu")
    assert out["mode"] == "federated" and out["f1"] == res.f1
    assert out["final_loss"] == res.losses[-1]
    assert out["energy_j"]["total"] == res.e_total
    assert '"federated"' in capsys.readouterr().out
    jcfg = jexp.make_config(n_sensors=12, n_fog=3, rounds=2, local_epochs=1, lr=0.01)
    assert (jcfg.rounds, jcfg.local_epochs, jcfg.lr) == (cfg.rounds, cfg.local_epochs, cfg.lr)


def test_train_production_resumes_from_its_checkpoint(tmp_path):
    argv = ["production", "--arch", "llama3-8b", "--steps", "2", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path)]
    first = ttrain.main(argv, device="cpu")
    assert first["start"] == 0 and first["finite"] and len(first["step_s"]) == 2
    store = CheckpointStore(str(tmp_path))
    assert store.steps() == [2]
    cfg = tconfigs.get("llama3-8b", reduced=True)
    saved, _ = store.restore(tapi.init_params(torch.Generator().manual_seed(5), cfg))
    # The same run by hand: params from the seed, two steps on its batches.
    g = torch.Generator().manual_seed(0)
    params = tapi.init_params(g, cfg)
    step = tapi.make_train_step(cfg)
    for _ in range(2):
        params, _ = step(params, {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                                          generator=g, dtype=torch.int32)})
    for a, b in zip(tsgd.tree_leaves(saved), tsgd.tree_leaves(params)):
        assert torch.equal(a, b)
    second = ttrain.main(argv[:4] + ["1"] + argv[5:], device="cpu")
    assert second["start"] == 2 and store.steps() == [2, 3]


def test_train_production_vlm_and_hybrid_on_cpu():
    for arch in ("internvl2-26b", "recurrentgemma-2b"):
        out = ttrain.main(["production", "--arch", arch, "--steps", "2", "--batch", "2",
                           "--seq", "24"], device="cpu")
        assert out["finite"] and out["tokens_per_s"] > 0


def test_train_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["production", "--arch", "llama3-8b", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["federated", "--sensors", "12", "--fog", "3", "--rounds", "1"])


def test_configs_param_count_and_training_fields():
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        assert tcfg.param_count() == jcfg.param_count()
        full_j, full_t = jconfigs.get(arch), tconfigs.get(arch)
        assert full_t.param_count() == full_j.param_count()
        assert (tcfg.learning_rate, tcfg.remat, tcfg.loss_chunks, tcfg.n_visual_tokens) == (
            jcfg.learning_rate, jcfg.remat, jcfg.loss_chunks, jcfg.n_visual_tokens)
        assert (full_t.loss_chunks, full_t.n_visual_tokens) == (
            full_j.loss_chunks, full_j.n_visual_tokens)
    for arch in jconfigs.ARCHS:     # all eleven, the paper AE's AEConfig included
        for reduced in (False, True):
            want, got = jconfigs.get(arch, reduced), tconfigs.get(arch, reduced)
            if arch == "paper_ae":
                assert got == type(got)(**dataclasses.asdict(want))
                continue
            assert got.param_count() == want.param_count()
            assert got.active_param_count() == want.active_param_count()
            assert (got.learning_rate, got.remat, got.loss_chunks) == (
                want.learning_rate, want.remat, want.loss_chunks)

"""Shared checks of the language-model parity tests: the port against the
JAX package on the CPU, at REDUCED size.

The reference's own params (``repro.models.api.init_params``) are carried
into the port by the family's ``from_numpy`` (bf16 bit for bit), and the
same numpy-drawn tokens (and frame embeddings, for an enc-dec model) go
through both.  Each reference result is computed once per process
(``functools.lru_cache``): JAX compiles every new shape, and one test file
runs in one worker (``--dist loadfile``).

Tolerances (those of ``test_torch_lm.py`` and ``test_torch_lm_train.py``):
- ``forward``: hidden states within ``1e-4`` of the largest; ``loss`` to
  ``rtol=1e-5``; a bf16 loss within ``2e-2`` relative.
- One train step at lr 1e-2: every gradient leaf within ``1e-4`` of the
  largest gradient coordinate and every update (new - old) within
  ``1e-4`` of the largest update coordinate.
- Decode, teacher-forced: logits and every cache leaf within ``2e-5``
  (f32) or ``4e-2`` (bf16) of the largest magnitude of the reference's
  array at that step; lengths exactly.
- Greedy tokens exactly.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro_torch import configs as tconfigs
from repro_torch.models import api as tapi
from repro_torch.models import layers as tL
from repro_torch.optim import sgd as tsgd

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
REL_TOL = {"f32": 2e-5, "bf16": 4e-2}
LR = 1e-2


def cfgs(arch: str, dtype: str = "f32", **kw):
    jd, td = DTYPES[dtype]
    return (jconfigs.get(arch, reduced=True).replace(dtype=jd, **kw),
            tconfigs.get(arch, reduced=True).replace(dtype=td, **kw))


@functools.lru_cache(maxsize=None)
def ref_params(arch: str, dtype: str = "f32"):
    """The reference's params from key 0; with ``qk_norm`` the q and k norm
    scales are set to distinct nonzero ramps (``init`` gives zeros, under
    which the ``1 + scale`` norms are plain RMSNorms)."""
    jcfg, _ = cfgs(arch, dtype)
    jp = japi.init_params(jax.random.key(0), jcfg)
    if jcfg.qk_norm:
        a = jp.blocks.attn
        ramp = jnp.linspace(-0.5, 0.5, jcfg.n_layers * jcfg.head_dim).reshape(a.q_norm.shape)
        a = a._replace(q_norm=ramp.astype(jcfg.dtype), k_norm=(0.3 - ramp).astype(jcfg.dtype))
        jp = jp._replace(blocks=jp.blocks._replace(attn=a))
    return jp


def carry(arch: str, dtype: str = "f32", **kw):
    """(jcfg, tcfg, reference params, the port's from them)."""
    jcfg, tcfg = cfgs(arch, dtype, **kw)
    jp = ref_params(arch, dtype)
    return jcfg, tcfg, jp, tapi.module(tcfg).from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def batches(jcfg, b: int = 2, s: int = 32, seed: int = 0):
    """The same batch for both: tokens, and an enc-dec model's frame
    embeddings (drawn in f32, rounded to the model's dtype once)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if jcfg.family == "encdec":
        aud = rng.standard_normal((b, jcfg.n_audio_frames, jcfg.d_model)).astype(np.float32)
        jb["audio_embeds"] = jnp.asarray(aud, jcfg.dtype)
        tb["audio_embeds"] = tL.tensor_from_array(np.asarray(jb["audio_embeds"]), "cpu")
    return jb, tb


def np32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def t2np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def assert_rel(got, want, tol, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(np.asarray(got, np.float32) - want)))
    assert err <= tol * scale, f"{what}: max |diff| {err:.3e} > {tol} * {scale:.3e}"


def _hidden(out):
    """A MoE forward returns (h, aux); the others h."""
    return out[0] if isinstance(out, tuple) else out


@functools.lru_cache(maxsize=None)
def ref_forward(arch: str, dtype: str = "f32", s: int = 32, seed: int = 0):
    """(hidden f32 numpy, the moe aux or None, loss) of the reference."""
    jcfg, _ = cfgs(arch, dtype)
    jp = ref_params(arch, dtype)
    jb, _ = batches(jcfg, s=s, seed=seed)
    jmod = japi.module(jcfg)
    out = jax.jit(lambda p, b: jmod.forward(p, b, jcfg))(jp, jb)
    aux = float(out[1]) if isinstance(out, tuple) else None
    loss = float(jax.jit(japi.loss_fn(jcfg))(jp, jb))
    return np32(_hidden(out)), aux, loss


def check_forward_and_loss(arch: str, s: int = 32):
    jcfg, tcfg, _, tp = carry(arch)
    _, tb = batches(jcfg, s=s)
    want_h, want_aux, want_loss = ref_forward(arch, "f32", s)
    out = tapi.module(tcfg).forward(tp, tb, tcfg)
    got_h = _hidden(out)
    assert tuple(got_h.shape) == want_h.shape and got_h.dtype == torch.float32
    assert_rel(t2np(got_h), want_h, 1e-4, "hidden")
    if want_aux is not None:
        np.testing.assert_allclose(float(out[1]), want_aux, rtol=1e-5)
    got = tapi.loss_fn(tcfg)(tp, tb)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want_loss, rtol=1e-5)


def check_bf16_loss(arch: str, s: int = 32):
    jcfg, tcfg, _, tp = carry(arch, "bf16")
    _, tb = batches(jcfg, s=s, seed=1)
    _, _, want = ref_forward(arch, "bf16", s, 1)
    got = float(tapi.loss_fn(tcfg)(tp, tb))
    assert abs(got - want) <= 2e-2 * abs(want), (got, want)


@functools.lru_cache(maxsize=None)
def ref_train_step(arch: str, s: int = 32):
    """(grad leaves, loss, update leaves) of one reference step at lr 1e-2."""
    jcfg, _ = cfgs(arch, learning_rate=LR)
    jp = ref_params(arch)
    jb, _ = batches(jcfg, s=s, seed=2)
    jloss, jgrads = jax.jit(jax.value_and_grad(japi.loss_fn(jcfg)))(jp, jb)
    jp2, jl = jax.jit(japi.make_train_step(jcfg))(jp, jb)
    upd = [np.asarray(a, np.float32) - np.asarray(b, np.float32)
           for a, b in zip(jax.tree.leaves(jp2), jax.tree.leaves(jp))]
    return [np.asarray(g) for g in jax.tree.leaves(jgrads)], float(jl), upd


def check_train_step(arch: str, s: int = 32):
    jcfg, tcfg, _, tp = carry(arch, learning_rate=LR)
    _, tb = batches(jcfg, s=s, seed=2)
    jg, jl, want = ref_train_step(arch, s)
    tgrads, _ = tsgd.grad_and_value(tapi.loss_fn(tcfg))(tp, tb)
    tg = [t2np(g) for g in tsgd.tree_leaves(tgrads)]
    assert [g.shape for g in jg] == [g.shape for g in tg]
    gmax = max(float(np.abs(g).max()) for g in jg)
    for i, (w, g) in enumerate(zip(jg, tg)):
        assert float(np.abs(w - g).max()) <= 1e-4 * gmax, f"gradient leaf {i}"
    tp2, tl = tapi.make_train_step(tcfg)(tp, tb)
    np.testing.assert_allclose(float(tl), jl, rtol=1e-5)
    assert type(tp2) is type(tp)
    got = [t2np(a) - t2np(b) for a, b in zip(tsgd.tree_leaves(tp2), tsgd.tree_leaves(tp))]
    umax = max(float(np.abs(u).max()) for u in want)
    for i, (w, g) in enumerate(zip(want, got)):
        assert float(np.abs(w - g).max()) <= 1e-4 * umax, f"update leaf {i}"


def check_prefill(arch: str, s: int = 32):
    jcfg, tcfg, jp, tp = carry(arch)
    jb, tb = batches(jcfg, s=s, seed=3)
    got = tapi.make_prefill_step(tcfg)(tp, tb)
    assert got.shape == (2, tcfg.d_model) and not got.requires_grad
    assert torch.equal(got, _hidden(tapi.module(tcfg).forward(tp, tb, tcfg))[:, -1, :])
    assert_rel(t2np(got), np32(jax.jit(japi.make_prefill_step(jcfg))(jp, jb)), 1e-4, "prefill")


@functools.lru_cache(maxsize=None)
def ref_decode(arch: str, dtype: str, steps: int, b: int = 2, cross: bool = False):
    """Per step: (logits, cache leaves) of the reference, teacher-forced on
    seed-7 tokens; with ``cross`` the enc-dec cache's cross K/V are the
    reference's ``precompute_cross_kv`` of the seed-0 batch's audio."""
    jcfg, _ = cfgs(arch, dtype)
    jp = ref_params(arch, dtype)
    jcache = japi.init_cache(jcfg, b, steps + 4)
    if cross:
        jmod = japi.module(jcfg)
        jb, _ = batches(jcfg, b=b)
        ck, cv = jmod.precompute_cross_kv(jp, jmod.encode(jp, jb["audio_embeds"], jcfg), jcfg)
        jcache = jcache._replace(cross_k=ck, cross_v=cv)
    jstep = jax.jit(japi.make_serve_step(jcfg))
    out = []
    for tok in decode_tokens(jcfg, steps, b):
        jcache, jl = jstep(jp, jcache, jnp.asarray(tok))
        out.append((np.asarray(jl), [np.asarray(x) for x in jax.tree.leaves(jcache)]))
    return out


def decode_tokens(jcfg, steps: int, b: int = 2) -> np.ndarray:
    return np.random.default_rng(7).integers(0, jcfg.vocab_size, (steps, b, 1)).astype(np.int32)


def check_decode(arch: str, dtype: str, steps: int, cross_kv=None):
    """Teacher-forced decode against :func:`ref_decode`; ``cross_kv`` sets
    the port's cross K/V (an enc-dec model's, from its own encoder)."""
    jcfg, tcfg, _, tp = carry(arch, dtype)
    b = 2
    tcache = tapi.init_cache(tcfg, b, steps + 4, device="cpu")
    if cross_kv is not None:
        tcache = tcache._replace(cross_k=cross_kv[0], cross_v=cross_kv[1])
    tstep = tapi.make_serve_step(tcfg)
    tol = REL_TOL[dtype]
    want = ref_decode(arch, dtype, steps, b, cross_kv is not None)
    for t, tok in enumerate(decode_tokens(jcfg, steps, b)):
        tcache, tl = tstep(tp, tcache, torch.from_numpy(tok))
        assert tl.dtype == torch.float32 and tl.shape == (b, 1, jcfg.vocab_size)
        jl, jleaves = want[t]
        assert_rel(t2np(tl), jl, tol, f"step {t} logits")
        tleaves_ = tL.leaves(tcache)
        assert len(jleaves) == len(tleaves_)
        for i, (jx, tx) in enumerate(zip(jleaves, tleaves_)):
            assert tuple(jx.shape) == tuple(tx.shape), f"cache leaf {i}"
            if tx.dtype == torch.int32:
                np.testing.assert_array_equal(tx.numpy(), jx)
            else:
                assert_rel(t2np(tx), np32(jx), tol, f"step {t} cache leaf {i}")
    return tcache


def check_init(arch: str, dtype: str):
    """The port's own init: the reference's tree of shapes and dtypes."""
    jcfg, tcfg = cfgs(arch, dtype)
    want = jax.eval_shape(lambda: japi.init_params(jax.random.key(0), jcfg))
    got = tapi.init_params(torch.Generator().manual_seed(0), tcfg)
    jl, tl_ = jax.tree.leaves(want), tsgd.tree_leaves(got)
    assert len(jl) == len(tl_)
    for w, g in zip(jl, tl_):
        assert tuple(w.shape) == tuple(g.shape)
        assert str(w.dtype) == {torch.float32: "float32", torch.bfloat16: "bfloat16"}[g.dtype]


def check_round_trip_bf16(arch: str):
    """``from_numpy`` then ``to_numpy`` gives the reference's leaves back
    exactly, f32 leaves staying f32 in a bf16 model."""
    jcfg, tcfg, jp, tp = carry(arch, "bf16")
    back = tapi.module(tcfg).to_numpy(tp)
    jl, bl = jax.tree.leaves(jp), jax.tree.leaves(back)
    assert len(jl) == len(bl)
    for w, g, t in zip(jl, bl, tsgd.tree_leaves(tp)):
        assert str(w.dtype) == {torch.float32: "float32", torch.bfloat16: "bfloat16"}[t.dtype]
        np.testing.assert_array_equal(g, np32(w))

"""Port parity for LM decode serving (recurrentgemma, llama3, gemma2, the
internvl2 LM), PyTorch vs JAX.

The reference's own params (``repro.models.api.init_params``) are carried
into the port by ``from_numpy`` (bf16 bit for bit), and the same
numpy-drawn tokens are fed to both decode steps, teacher-forced, on the
CPU: there the port's windowed, uncapped attention layers run the plain
version of the ``swa_decode`` kernel, and the reference (which sets no
``use_pallas_swa``) its plain masked softmax.

Tolerances, each relative to the largest magnitude of the reference's
array at that step (logits, every cache leaf; lengths exactly):
- f32: ``2e-5``.  Summation orders differ (measured <= 5e-6 over 96 steps).
- bf16: ``4e-2``, about ten bf16 ulps of the largest entry.  Both sides
  round to bf16 after every product, but not at the same places: the
  kernel's route keeps the attention probabilities in f32 where the
  reference's plain branch casts them to bf16 (measured <= 1.8e-2).
- Layers: f32 to ``rtol=1e-5, atol=1e-6`` (rope to ``atol=1e-5``: cos and
  sin of angles up to ~5e3 rad in two libms); bf16 equal or one ulp.
- Attention steps: ``atol=2e-5, rtol=1e-4``, the SWA kernel's tolerance.
- Greedy tokens exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_parity import one_intra_op_thread  # noqa: F401

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import layers as jL
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tL
from repro_torch.models import rglru, transformer

ARCHS = {"recurrentgemma-2b": rglru, "llama3-8b": transformer, "gemma2-27b": transformer,
         "internvl2-26b": transformer}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
REL_TOL = {"f32": 2e-5, "bf16": 4e-2}
ATTN_TOL = dict(atol=2e-5, rtol=1e-4)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t2np(t):
    return t.detach().to(torch.float32).numpy()


def _ulps_le_one(a_bf16: torch.Tensor, b_bf16: torch.Tensor) -> bool:
    def ordered(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32)
        mag = bits & 0x7FFF
        return torch.where(bits < 0, -mag, mag)
    return bool(torch.all(torch.abs(ordered(a_bf16) - ordered(b_bf16)) <= 1))


def _cfgs(arch, dtype):
    jd, td = DTYPES[dtype]
    return (jconfigs.get(arch, reduced=True).replace(dtype=jd),
            tconfigs.get(arch, reduced=True).replace(dtype=td))


def _carry(arch, jcfg):
    jp = japi.init_params(jax.random.key(0), jcfg)
    return jp, ARCHS[arch].from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _tleaves(tree):
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [x for t in tree for x in _tleaves(t)]
    return [tree]


def _assert_rel(got, want, tol, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(np.asarray(got, np.float32) - want)))
    assert err <= tol * scale, f"{what}: max |diff| {err:.3e} > {tol} * {scale:.3e}"


# --- layers -----------------------------------------------------------------

def test_gelu_is_jax_default_tanh_approximation():
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 4
    np.testing.assert_allclose(tL.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(x)), rtol=1e-5, atol=1e-6)
    assert not np.allclose(F.gelu(torch.from_numpy(x)).numpy(), np.asarray(jax.nn.gelu(x)),
                           rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_scales_by_one_plus_scale(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 256)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(256)).astype(np.float32)
    want = jL.rms_norm(jnp.asarray(x, jd), jnp.asarray(scale, jd))
    got = tL.rms_norm(torch.from_numpy(x).to(td), torch.from_numpy(scale).to(td))
    assert got.dtype == td
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    else:
        assert _ulps_le_one(got, tL.tensor_from_array(np.asarray(want), "cpu"))


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_rotates_split_halves(theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 4, 64)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    want = jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tL.rope_frequencies(64, theta).numpy(),
                               np.asarray(jL.rope_frequencies(64, theta)), rtol=1e-6)


def test_softcap_and_swiglu():
    rng = np.random.default_rng(3)
    x = (30 * rng.standard_normal(512)).astype(np.float32)
    np.testing.assert_allclose(tL.softcap(torch.from_numpy(x), 50.0).numpy(),
                               np.asarray(jL.softcap(jnp.asarray(x), 50.0)), rtol=1e-5, atol=1e-6)
    h = rng.standard_normal((2, 3, 32)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.2 for s in ((32, 48), (32, 48), (48, 32))]
    for jact, tact in ((jax.nn.silu, F.silu), (jax.nn.gelu, tL.gelu)):
        want = jL.swiglu(jnp.asarray(h), *map(jnp.asarray, ws), act=jact)
        got = tL.swiglu(torch.from_numpy(h), *map(torch.from_numpy, ws), act=tact)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_init_matches_reference_shapes_and_dtypes(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    want = jax.tree.leaves(jax.eval_shape(lambda k: japi.init_params(k, jcfg), jax.random.key(0)))
    got = _tleaves(tapi.init_params(torch.Generator().manual_seed(0), tcfg))
    assert [tuple(w.shape) for w in want] == [tuple(g.shape) for g in got]
    assert [np.dtype(w.dtype).name for w in want] == [str(g.dtype).split(".")[1] for g in got]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_from_numpy_to_numpy_round_trip_bf16(arch):
    jcfg, _ = _cfgs(arch, "bf16")
    jp, tp = _carry(arch, jcfg)
    back = jax.tree.leaves(ARCHS[arch].to_numpy(tp))
    for w, g in zip(jax.tree.leaves(jp), back):
        np.testing.assert_array_equal(_np(w), g)
        assert np.asarray(jnp.asarray(g, w.dtype) == w).all()


# --- attention.decode_step --------------------------------------------------

def _attn_case(heads, kv, hd, seed=0, d_model=48):
    jp = jattn.init(jax.random.key(seed), d_model, heads, kv, hd, False, jnp.float32)
    tp = tattn.AttnParams(*(None if a is None else tL.tensor_from_array(np.asarray(a), "cpu")
                            for a in jp))
    return jp, tp


@pytest.mark.parametrize("heads,kv,hd,window,softcap", [
    (4, 2, 32, None, None),       # plain, no window
    (4, 2, 32, 8, None),          # windowed, uncapped: the kernel's route
    (4, 2, 32, 8, 50.0),          # windowed, soft-capped: plain
    (4, 1, 64, 2 ** 30, None),    # a "global" layer: the kernel's route, causal
])
def test_attention_decode_step_matches_reference_past_max_seq(heads, kv, hd, window, softcap):
    """18 steps into a 12-slot cache: from step 12 on every write clamps to
    the last slot while the length grows (the window never empties:
    length stays below S + window)."""
    b, max_seq, steps, d_model = 2, 12, 18, 48
    jp, tp = _attn_case(heads, kv, hd)
    jc = jattn.init_cache(b, max_seq, kv, hd, jnp.float32)
    tc = tattn.init_cache(b, max_seq, kv, hd, torch.float32, "cpu")
    xs = np.random.default_rng(4).standard_normal((steps, b, 1, d_model)).astype(np.float32)
    jstep = jax.jit(lambda c, x: jattn.decode_step(jp, c, x, window=window, attn_softcap=softcap))
    for t in range(steps):
        jc, jy = jstep(jc, jnp.asarray(xs[t]))
        tc, ty = tattn.decode_step(tp, tc, torch.from_numpy(xs[t]), window=window,
                                   attn_softcap=softcap)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **ATTN_TOL)
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **ATTN_TOL)
        np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **ATTN_TOL)
        np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    assert int(tc.length[0]) == steps > max_seq


@pytest.mark.parametrize("lens", [[300, 77], [511, 40], [600, 590]])
def test_windowed_branch_matches_reference_pallas_swa(lens):
    """One step from a filled 512-slot cache (the TPU kernel's tiling)
    against the reference's ``use_pallas_swa=True`` in interpret mode; the
    last case's rows have empty windows (lengths past S + window after the
    clamped write): zeros on both sides."""
    b, s, heads, kv, hd, window, d_model = 2, 512, 4, 2, 32, 64, 48
    jp, tp = _attn_case(heads, kv, hd, seed=1)
    rng = np.random.default_rng(5)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    x = rng.standard_normal((b, 1, d_model)).astype(np.float32)
    ln = np.asarray(lens, np.int32)
    jc, jy = jattn.decode_step(jp, jattn.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(ln)),
                               jnp.asarray(x), window=window, use_pallas_swa=True)
    tc, ty = tattn.decode_step(
        tp, tattn.KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
                          torch.from_numpy(ln)), torch.from_numpy(x), window=window)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **ATTN_TOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **ATTN_TOL)
    if min(lens) >= s + window - 1:
        assert np.all(ty.numpy() == 0.0) and np.all(np.asarray(jy) == 0.0)


def test_empty_window_differs_from_reference_plain_branch():
    """Past S + window tokens the reference's plain branch averages the
    whole cache (its finite NEG_INF mask); the port's kernel route gives
    zeros as the TPU kernel does (a reference fault, not reproduced)."""
    b, s, heads, kv, hd, window = 1, 8, 4, 2, 32, 4
    jp, tp = _attn_case(heads, kv, hd, seed=2)
    rng = np.random.default_rng(6)
    k, v = (rng.standard_normal((b, s, kv, hd)).astype(np.float32) for _ in range(2))
    x = rng.standard_normal((b, 1, 48)).astype(np.float32)
    ln = np.asarray([s + window], np.int32)
    _, jy = jattn.decode_step(jp, jattn.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(ln)),
                              jnp.asarray(x), window=window)
    _, ty = tattn.decode_step(tp, tattn.KVCache(torch.from_numpy(k), torch.from_numpy(v),
                                                torch.from_numpy(ln)),
                              torch.from_numpy(x), window=window)
    assert np.all(ty.numpy() == 0.0)
    assert np.max(np.abs(np.asarray(jy))) > 1e-3


# --- whole models, teacher-forced -------------------------------------------

@pytest.mark.parametrize("arch,dtype,long_context", [
    (a, dt, False) for a in ARCHS for dt in ("f32", "bf16")
] + [("recurrentgemma-2b", "f32", True)])
def test_decode_teacher_forced_matches_reference(arch, dtype, long_context):
    """96 steps (100 with ``long_context``, whose 64-slot cache clamps from
    step 64 on and stays below the empty window at 128), batch 2: logits
    and every cache leaf at every step.  REDUCED windows are 64, so every
    windowed layer slides."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _carry(arch, jcfg)
    b, steps = 2, 100 if long_context else 96
    max_seq = steps + 4
    jcache = japi.init_cache(jcfg, b, max_seq, long_context)
    tcache = tapi.init_cache(tcfg, b, max_seq, long_context, device="cpu")
    jstep = jax.jit(japi.make_serve_step(jcfg, long_context))
    tstep = tapi.make_serve_step(tcfg, long_context)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (steps, b, 1)).astype(np.int32)
    tol = REL_TOL[dtype]
    for t in range(steps):
        jcache, jl = jstep(jp, jcache, jnp.asarray(toks[t]))
        tcache, tl = tstep(tp, tcache, torch.from_numpy(toks[t]))
        assert tl.dtype == torch.float32 and tl.shape == (b, 1, jcfg.vocab_size)
        _assert_rel(_t2np(tl), np.asarray(jl), tol, f"step {t} logits")
        jleaves, tleaves = jax.tree.leaves(jcache), _tleaves(tcache)
        assert len(jleaves) == len(tleaves)
        for i, (jx, tx) in enumerate(zip(jleaves, tleaves)):
            assert tuple(jx.shape) == tuple(tx.shape)
            if tx.dtype == torch.int32:
                np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
            else:
                _assert_rel(_t2np(tx), _np(jx), tol, f"step {t} cache leaf {i}")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_serve_greedy_tokens_match_reference(arch):
    jcfg, tcfg = _cfgs(arch, "f32")
    jp, tp = _carry(arch, jcfg)
    b, plen, n_new = 2, 16, 16
    prompts = np.random.default_rng(8).integers(0, jcfg.vocab_size, (b, plen)).astype(np.int32)
    jc = japi.init_cache(jcfg, b, plen + n_new + 1)
    jc, jl = jserve.prefill_into_cache(jcfg, jp, jc, jnp.asarray(prompts))
    want = np.asarray(jserve.decode_tokens(jcfg, jp, jc, jl, n_new, jax.random.key(0)))
    tc = tapi.init_cache(tcfg, b, plen + n_new + 1, device="cpu")
    tc, tl = tserve.prefill_into_cache(tcfg, tp, tc, torch.from_numpy(prompts))
    _assert_rel(_t2np(tl), np.asarray(jl), REL_TOL["f32"], "prefill logits")
    _, got = tserve.decode_tokens(tcfg, tp, tc, tl, n_new)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_tokens_returns_the_cache_after_its_last_step(arch):
    """Decoding 4 tokens from a prefilled state returns the cache that
    stepping those 4 tokens by hand gives (every leaf equal), and one step
    from it with the 5th token of an 8-token decode from the same state
    gives that decode's 6th token (greedy, REDUCED f32)."""
    import copy

    _, cfg = _cfgs(arch, "f32")
    params = tapi.init_params(torch.Generator().manual_seed(0), cfg)
    prompts = torch.randint(0, cfg.vocab_size, (2, 6), generator=torch.Generator().manual_seed(1),
                            dtype=torch.int32)
    cache = tapi.init_cache(cfg, 2, 16, device="cpu")
    cache, logits = tserve.prefill_into_cache(cfg, params, cache, prompts)
    _, want = tserve.decode_tokens(cfg, params, copy.deepcopy(cache), logits, 8)
    by_hand = copy.deepcopy(cache)
    step = tapi.make_serve_step(cfg)
    for t in range(4):
        by_hand, _ = step(params, by_hand, want[:, t:t + 1])
    cache4, toks4 = tserve.decode_tokens(cfg, params, cache, logits, 4)
    np.testing.assert_array_equal(toks4.numpy(), want[:, :4].numpy())
    got_leaves, want_leaves = _tleaves(cache4), _tleaves(by_hand)
    assert len(got_leaves) == len(want_leaves)
    assert all(torch.equal(x, y) for x, y in zip(got_leaves, want_leaves))
    _, nxt = step(params, cache4, want[:, 4:5])
    np.testing.assert_array_equal(torch.argmax(nxt[:, -1], dim=-1).numpy(), want[:, 5].numpy())


def test_lm_entry_points_default_to_the_card(monkeypatch):
    """``device=None`` means the card: with none, the caches and the
    serving driver raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get("recurrentgemma-2b", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tattn.init_cache(2, 8, 1, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.init_cache(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "llama3-8b", "--batch", "2", "--new-tokens", "2"])


@pytest.mark.parametrize("arch", list(ARCHS))
def test_serve_main_on_cpu(arch, capsys):
    out = tserve.main(["--arch", arch, "--batch", "2", "--prompt-len", "8",
                       "--new-tokens", "4"], device="cpu")
    assert out["device"] == "cpu" and len(out["sample_output"]) == 4
    assert all(0 <= t < tconfigs.get(arch, reduced=True).vocab_size for t in out["sample_output"])
    assert '"arch"' in capsys.readouterr().out


def test_unported_archs_and_families_raise():
    """Every family of the reference is ported: only an arch or a family
    that the reference does not have raises."""
    with pytest.raises(ValueError, match="unknown arch"):
        tconfigs.get("qwen2-moe-a9b")
    with pytest.raises(ValueError, match="unknown model family"):
        tapi.module(tconfigs.get("llama3-8b", reduced=True).replace(family="rnn"))
    for family in ("dense", "vlm", "moe", "ssm", "hybrid", "encdec"):
        cfg = tconfigs.get("llama3-8b", reduced=True).replace(family=family)
        assert tapi.module(cfg).__name__ == japi.module(cfg).__name__.replace("repro.",
                                                                               "repro_torch.")

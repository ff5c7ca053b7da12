"""The pod family (``core/mesh_fl``, ``Engine.pod_train_step``) and the
federated-LLM example on the CPU, against the JAX package.

The reference's own pod step cannot run here (its sharding constraint
fails under jax 0.9: ``tests/test_mesh_fl.py::
test_pod_hfl_step_single_pod_mesh``), so the port's step is held against
a composition: ``jax.value_and_grad(repro.models.api.loss_fn(cfg))`` per
pod (or ``repro.optim.sgd.local_sgd`` for E > 1) and the exchange of
``repro/core/mesh_fl.py:126-186`` written here in numpy, with the step's
update of ``:240-245``.  llama3-8b REDUCED in f32 with the reference's
params, lr 1e-2.  Gates: loss ``rtol=1e-5``; params and error-feedback
buffers ``atol=1e-5``, except where the two sides' gradients (equal to
~1e-6 relative) round one coordinate to neighbouring int8 codes: there
the err differs by one quantisation step.  A code flips when v / scale
lies within ~127 x 1e-6 of a half-integer, so at most ~3e-4 of the
coordinates can (in ``topk`` mode also two coordinates swapping at the
k-th magnitude of a block); such coordinates are held to one step and
counted, at most one in 10^3 of a leaf's, or two.  The int8 scale is max|v| times
f32(1/127), the product the reference's jitted division computes.

Two gloo ranks (``tests/torch_mesh_ranks.py``) are bitwise the
single-process 2-pod loop, in both modes.
"""
import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_mesh_ranks import run_ranks
from torch_parity import one_intra_op_thread  # noqa: F401

from repro import configs as jconfigs
from repro.core import compression as jcomp
from repro.core import mesh_fl as jmesh
from repro.models import api as japi
from repro.optim.sgd import local_sgd as jlocal_sgd
from repro_torch import configs as tconfigs
from repro_torch.core import compression as tcomp
from repro_torch.core import mesh_fl
from repro_torch.data.pipeline import lm_batches
from repro_torch.engine import Engine
from repro_torch.examples import federated_llm
from repro_torch.kernels import _launch, ops, ref
from repro_torch.kernels import quant8 as kq8
from repro_torch.kernels import topk_ef as ktk
from repro_torch.models import api as tapi
from repro_torch.models import transformer
from repro_torch.optim import sgd as tsgd

ARCH = "llama3-8b"
LR = 1e-2
B, S = 4, 16
INV127 = np.float32(1.0 / 127.0)
FLIP_SHARE = 1e-3
TIMEOUT_S = 120.0


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfigs.get(ARCH, reduced=True).replace(dtype=jnp.float32, learning_rate=LR)
    tcfg = tconfigs.get(ARCH, reduced=True).replace(dtype=torch.float32, learning_rate=LR)
    jp = japi.init_params(jax.random.key(0), jcfg)
    tp = transformer.from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, tcfg, jp, tp, toks


# --- the compact codec ----------------------------------------------------------

def test_compact_roundtrip_ef_invariant():
    """The reference's own test on the port: survivors within amax / 127,
    dropped coordinates zero, at most k a block."""
    n = 10_000
    flat = torch.from_numpy(np.random.default_rng(0).standard_normal(n).astype(np.float32))
    q, idx, scale = mesh_fl.compress_compact(flat, rho_s=0.05)
    assert (q.dtype, idx.dtype, scale.dtype) == (torch.int8, torch.int32, torch.float32)
    recon = mesh_fl.decompress_compact(q, idx, scale, n)
    nnz = torch.nonzero(recon).flatten()
    amax = float(flat.abs().max())
    np.testing.assert_allclose(recon[nnz].numpy(), flat[nnz].numpy(), atol=amax / 127.0)
    k = max(1, round(0.05 * mesh_fl.BLOCK))
    assert len(nnz) <= -(-n // mesh_fl.BLOCK) * k
    # EF invariant: what the buffer keeps plus what went out is v, exactly.
    err = flat - recon
    assert torch.equal(err + recon, flat)


@pytest.mark.parametrize("n,rho_s", [(10_000, 0.05), (4096, 0.01), (9000, 0.3), (17, 0.05)])
def test_compact_matches_reference(n, rho_s):
    flat = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    jq, jidx, jscale = jax.jit(lambda f: jmesh.compress_compact(f, rho_s))(jnp.asarray(flat))
    want = np.asarray(jax.jit(lambda a, b, c: jmesh.decompress_compact(a, b, c, n))(
        jq, jidx, jscale))
    q, idx, scale = mesh_fl.compress_compact(torch.from_numpy(flat), rho_s)
    assert tuple(q.shape) == jq.shape and tuple(scale.shape) == jscale.shape
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    # Reconstructions, not index order: past n (and wherever |v| ties) the
    # two top-k's may pick other coordinates of equal magnitude.
    np.testing.assert_array_equal(mesh_fl.decompress_compact(q, idx, scale, n).numpy(), want)


def test_compact_keeps_largest_per_block():
    flat = torch.zeros(mesh_fl.BLOCK)
    flat[7], flat[100] = 5.0, -3.0
    q, idx, scale = mesh_fl.compress_compact(flat, rho_s=2 / mesh_fl.BLOCK)
    recon = mesh_fl.decompress_compact(q, idx, scale, mesh_fl.BLOCK)
    assert float(recon[7]) == pytest.approx(5.0, rel=0.02)
    assert float(recon[100]) == pytest.approx(-3.0, rel=0.02)


@pytest.mark.parametrize("d", [1, 4096, 4097, 1_443_072, 8_030_261_248])
@pytest.mark.parametrize("rho_s", [0.05, 0.01, 1.0])
def test_wire_bytes_equal_reference(d, rho_s):
    assert mesh_fl.wire_bytes(d, rho_s) == jmesh.wire_bytes(d, rho_s)


def test_init_err_shapes():
    tcfg = tconfigs.get(ARCH, reduced=True)
    params = tapi.init_params(torch.Generator().manual_seed(0), tcfg)
    for lead in (None, 1, 3):
        err = mesh_fl.init_err(params, lead)
        for p, e in zip(tsgd.tree_leaves(params), tsgd.tree_leaves(err)):
            assert e.dtype == torch.float32 and not e.any()
            assert tuple(e.shape) == ((() if lead is None else (lead,)) + tuple(p.shape))


# --- the pod step against a JAX composition ----------------------------------------

def _np_int8(v):
    scale = np.float32(np.abs(v).max()) * INV127
    safe = scale if scale > 0 else np.float32(1.0)
    q = np.clip(np.round(v / safe), -127, 127).astype(np.int8)
    return q, q.astype(np.float32) * safe, q.astype(np.float32) * scale


def _np_topk(v, rho_s):
    n = v.size
    nb = -(-n // jmesh.BLOCK)
    k = max(1, int(round(rho_s * jmesh.BLOCK)))
    blocks = np.zeros(nb * jmesh.BLOCK, np.float32)
    blocks[:n] = v.reshape(-1)
    blocks = blocks.reshape(nb, jmesh.BLOCK)
    out, codes = np.zeros_like(blocks), np.zeros((nb, k), np.int8)
    for b in range(nb):
        idx = np.argsort(-np.abs(blocks[b]), kind="stable")[:k]
        vals = blocks[b, idx]
        scale = np.float32(np.abs(vals).max()) * INV127
        safe = scale if scale > 0 else np.float32(1.0)
        codes[b] = np.clip(np.round(vals / safe), -127, 127).astype(np.int8)
        out[b, idx] = codes[b].astype(np.float32) * scale
    recon = out.reshape(-1)[:n].reshape(v.shape)
    return codes, recon, recon


def _composition(jcfg, jp, toks, n_pods, mode, local_epochs, steps, rho_s=0.05, sw=0.5):
    """The reference's step, composed: returns (params, err, losses) as
    numpy leaves and floats after ``steps`` steps."""
    lfn = japi.loss_fn(jcfg)
    grad = jax.jit(jax.value_and_grad(lfn))
    local = jax.jit(lambda p, b: jlocal_sgd(lfn, p, b, LR))
    params = [np.asarray(x) for x in jax.tree.leaves(jp)]
    treedef = jax.tree.structure(jp)
    err = [np.zeros((n_pods,) + p.shape, np.float32) for p in params]
    losses, per = [], B // n_pods
    for _ in range(steps):
        tree = jax.tree.unflatten(treedef, [jnp.asarray(p) for p in params])
        pod_loss, pod_upd = [], []
        for p in range(n_pods):
            pb = {"tokens": jnp.asarray(toks[p * per:(p + 1) * per])}
            if local_epochs == 1:
                loss, g = grad(tree, pb)
                pod_upd.append([np.asarray(x) for x in jax.tree.leaves(g)])
            else:
                batches = jax.tree.map(lambda x: jnp.stack([x] * local_epochs), pb)
                p1, loss = local(tree, batches)
                pod_upd.append([np.asarray(a) - b for a, b in zip(jax.tree.leaves(p1), params)])
            pod_loss.append(np.float32(loss))
        own_w, peer_w = sw, (1.0 - sw) / max(n_pods - 1, 1)
        new_params, new_err = [], []
        for i, p in enumerate(params):
            recon_own, recon_all, errs = [], [], []
            for pod in range(n_pods):
                v = pod_upd[pod][i].astype(np.float32) + err[i][pod]
                _, own, sent = _np_int8(v) if mode == "int8" else _np_topk(v, rho_s)
                errs.append(v - own)
                recon_all.append(sent)
            total = recon_all[0]
            for r in recon_all[1:]:
                total = total + r
            upd = None
            for r in recon_all:
                mixed = own_w * r + peer_w * (total - r)
                upd = mixed if upd is None else upd + mixed
            upd = upd / np.float32(n_pods)
            scale = -LR if local_epochs == 1 else 1.0
            new_params.append((p + np.float32(scale) * upd).astype(np.float32))
            new_err.append(np.stack(errs))
        params, err = new_params, new_err
        total = pod_loss[0]
        for x in pod_loss[1:]:
            total = total + x
        losses.append(float(total / np.float32(n_pods)))
    return params, err, losses


def _assert_close_but_flips(got, want, what, step):
    """atol 1e-5, except coordinates one quantisation step apart (``step``
    the largest step of the leaf), at most ``FLIP_SHARE`` of them."""
    diff = np.abs(got - want)
    far = diff > 1e-5
    if far.any():
        assert np.all(diff[far] <= 1.001 * step + 1e-5), (
            f"{what}: max |diff| {diff.max():.3e} beyond one step {step:.3e}")
        assert far.sum() <= max(2, FLIP_SHARE * got.size), f"{what}: {far.sum()} coordinates apart"
    return int(far.sum())


@pytest.mark.parametrize("local_epochs", [1, 2])
@pytest.mark.parametrize("mode", ["int8", "topk"])
@pytest.mark.parametrize("n_pods", [1, 2])
def test_pod_step_matches_reference_composition(setup, n_pods, mode, local_epochs):
    jcfg, tcfg, jp, tp, toks = setup
    steps = 2
    want_p, want_e, want_l = _composition(jcfg, jp, toks, n_pods, mode, local_epochs, steps)
    step = mesh_fl.make_pod_hfl_train_step(tcfg, None, mode=mode, local_epochs=local_epochs,
                                           n_pods=n_pods)
    params, err = tp, mesh_fl.init_err(tp, n_pods)
    batch = {"tokens": torch.from_numpy(toks)}
    losses = []
    for _ in range(steps):
        params, err, loss = step(params, err, batch)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want_l, rtol=1e-5)
    for i, (g, w) in enumerate(zip(tsgd.tree_leaves(params), want_p)):
        # a flipped code moves the param by lr (or 1) x one step of the exchange
        qstep = np.abs(want_e[i]).max() * 2 + 1e-30
        _assert_close_but_flips(g.numpy(), w, f"param {i}", qstep * (LR if local_epochs == 1
                                                                      else 1.0))
    for i, (g, w) in enumerate(zip(tsgd.tree_leaves(err), want_e)):
        assert tuple(g.shape) == w.shape
        _assert_close_but_flips(g.numpy(), w, f"err {i}", np.abs(w).max() * 2 + 1e-30)


def test_pod_step_learns_and_stays_finite(setup):
    """The reference's learnability check (``tests/test_mesh_fl.py:40-60``)
    on the port: one pod, int8, three steps on a fixed batch."""
    cfg = tconfigs.get(ARCH, reduced=True).replace(learning_rate=1e-2)
    step = mesh_fl.make_pod_hfl_train_step(cfg, None, mode="int8")
    params = tapi.init_params(torch.Generator().manual_seed(0), cfg)
    err = mesh_fl.init_err(params, 1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=torch.Generator().manual_seed(0))}
    losses = []
    for _ in range(3):
        params, err, loss = step(params, err, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    for leaf in tsgd.tree_leaves(params):
        assert bool(torch.isfinite(leaf.float()).all())


def test_one_pod_halves_the_compressed_update(setup):
    """With one pod and self_weight 0.5 the reference's mix is
    ``0.5 recon + 0.5 (sum - recon)`` with sum = recon: half the
    compressed gradient, not the identity its test's docstring claims."""
    _, tcfg, _, tp, toks = setup
    batch = {"tokens": torch.from_numpy(toks)}
    step = mesh_fl.make_pod_hfl_train_step(tcfg, None, mode="int8")
    new, err, _ = step(tp, mesh_fl.init_err(tp, 1), batch)
    grads, _ = tsgd.grad_and_value(tapi.loss_fn(tcfg))(tp, batch)
    for p, n, g, e in zip(*(tsgd.tree_leaves(t) for t in (tp, new, grads, err))):
        recon = g - e[0]                  # what the pod sent, decoded
        want = p + (-LR) * (0.5 * recon + 0.5 * (recon - recon))
        torch.testing.assert_close(n, want, rtol=0, atol=0)


def test_local_epochs_moves_further_and_err_fills(setup):
    """The reference's E > 1 check (``tests/test_fused_local_train.py:226``):
    a production lr still leaves a nonzero error buffer; E = 2's loss is
    at most E = 1's; E = 2 moves further."""
    _, tcfg, _, tp, toks = setup
    batch = {"tokens": torch.from_numpy(toks[:2])}
    err = mesh_fl.init_err(tp, 1)
    p1, _, l1 = mesh_fl.make_pod_hfl_train_step(tcfg, None, local_epochs=1)(tp, err, batch)
    p2, _, l2 = mesh_fl.make_pod_hfl_train_step(tcfg, None, local_epochs=2)(tp, err, batch)
    _, e_small, _ = mesh_fl.make_pod_hfl_train_step(
        tcfg.replace(learning_rate=1e-4), None, local_epochs=2)(tp, err, batch)
    assert sum(float(e.abs().sum()) for e in tsgd.tree_leaves(e_small)) > 0.0
    assert float(l2) <= float(l1) + 1e-6

    def moved(p):
        return sum(float((a - b).abs().sum()) for a, b in zip(tsgd.tree_leaves(p),
                                                               tsgd.tree_leaves(tp)))
    assert moved(p2) > moved(p1) > 0.0


def test_engine_pod_train_step_runs_one_pod_and_caches(setup):
    _, tcfg, _, tp, toks = setup
    eng = Engine(device="cpu")
    step = eng.pod_train_step(tcfg)
    assert eng.pod_train_step(tcfg) is step and eng.compile_count == 1
    assert eng.pod_train_step(tcfg, mode="topk") is not step
    got = step(tp, mesh_fl.init_err(tp, 1), {"tokens": torch.from_numpy(toks)})
    want = mesh_fl.make_pod_hfl_train_step(tcfg, None)(tp, mesh_fl.init_err(tp, 1),
                                                       {"tokens": torch.from_numpy(toks)})
    assert torch.equal(got[2], want[2])
    for a, b in zip(tsgd.tree_leaves(got[0]), tsgd.tree_leaves(want[0])):
        assert torch.equal(a, b)


def test_pod_step_rejects_a_ragged_batch(setup):
    _, tcfg, _, tp, toks = setup
    step = mesh_fl.make_pod_hfl_train_step(tcfg, None, n_pods=3)
    with pytest.raises(ValueError, match="3 pods"):
        step(tp, mesh_fl.init_err(tp, 3), {"tokens": torch.from_numpy(toks)})
    with pytest.raises(ValueError, match="mode"):
        mesh_fl.make_pod_hfl_train_step(tcfg, None, mode="fp8")(
            tp, mesh_fl.init_err(tp, 1), {"tokens": torch.from_numpy(toks)})


def test_two_gloo_ranks_are_bitwise_the_two_pod_loop(setup, tmp_path):
    """Rank r is pod r: both modes, E = 1 and 2; every rank's params equal
    bitwise, and equal to the one-process loop over 2 pods, as are each
    rank's error buffers to the loop's pod r and the losses.  The int8
    exchange gathers ``torch.int8`` over gloo."""
    _, tcfg, _, tp, toks = setup
    cases = [("int8", 1), ("topk", 1), ("int8", 2)]
    batch = {"tokens": torch.from_numpy(toks)}
    jobs = [("pod", tcfg, tp, batch, dict(mode=m, local_epochs=e), 2) for m, e in cases]
    ranks = run_ranks(jobs, 2, tmp_path / "ranks", timeout_s=TIMEOUT_S)
    for j, (mode, e) in enumerate(cases):
        step = mesh_fl.make_pod_hfl_train_step(tcfg, None, mode=mode, local_epochs=e, n_pods=2)
        params, err = tp, mesh_fl.init_err(tp, 2)
        losses = []
        for _ in range(2):
            params, err, loss = step(params, err, batch)
            losses.append(loss)
        flat = tsgd.ravel_tree(params)
        for r in range(2):
            got = ranks[r][j]
            assert torch.equal(got["params"], flat), (mode, e, r)
            assert torch.equal(got["err"], tsgd.ravel_tree([x[r] for x in tsgd.tree_leaves(err)]))
            assert torch.equal(got["losses"], torch.stack(losses))


# --- the example and the compressor at large d --------------------------------------

def test_federated_llm_payload_line_is_the_reference_formula(capsys):
    out = federated_llm.main([], steps=2, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    d = out["d"]
    jc = jcomp.CompressorConfig(rho_s=0.05, quant_bits=8, mode="blockwise")
    jparams = japi.init_params(jax.random.key(0), jconfigs.get(ARCH, reduced=True))
    assert d == sum(x.size for x in jax.tree.leaves(jparams))
    bits = jcomp.payload_bits(d, jc)
    want = (f"compressed cross-pod payload: {bits / 8 / 1024:.1f} KiB "
            f"(vs {32 * d / 8 / 1024:.1f} KiB dense, {jcomp.compression_ratio(d, jc):.1%})")
    assert want in lines
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))


def test_federated_llm_step_is_the_plain_composition():
    """One step of the example at size 1 is the compressed client update
    added to the params: ``compress_update`` of -1e-3 x the flat gradient
    with a zero error buffer, then ring mix and mean as identities."""
    cfg = tconfigs.get(ARCH, reduced=True)
    out = federated_llm.main([], steps=1, device="cpu")
    params = tapi.init_params(torch.Generator().manual_seed(0), cfg)
    stream = torch.randint(0, cfg.vocab_size, (4096,), generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    batch = {"tokens": lm_batches(torch.Generator().manual_seed(2), stream, 2, 32)}
    grads, _ = tsgd.grad_and_value(tapi.loss_fn(cfg))(params, batch)
    flat = -1e-3 * tsgd.ravel_tree([g.float() for g in tsgd.tree_leaves(grads)])
    recon, _ = tcomp.compress_update(flat[None], torch.zeros_like(flat)[None],
                                     tcomp.CompressorConfig(rho_s=0.05, quant_bits=8))
    upd = 0.8 * recon[0] + 0.2 * recon[0]
    pieces = tsgd.unravel_tree(upd, tsgd.tree_leaves(params))
    for p, u, got in zip(tsgd.tree_leaves(params), pieces, tsgd.tree_leaves(out["params"])):
        assert torch.equal(got, (p.float() + u).to(p.dtype))


def test_compress_recon_without_an_index_is_bitwise_the_gather():
    """``ops.compress``'s recon from the (N, nb, 8192) view equals the old
    per-coordinate gather of the block scales, at a ragged d."""
    g = torch.Generator().manual_seed(0)
    for n, d in ((3, 8209), (1, 8192), (2, 100)):
        delta = torch.randn((n, d), generator=g)
        err = torch.randn((n, d), generator=g) * 0.1
        recon, new_err, bits = ops.compress(delta, err, 0.05)
        q, scale, want_err = ref.compress_ref(delta, err, ops.block_k(0.05))
        block_of = torch.arange(d) // ops.BLOCK_ELEMS
        assert torch.equal(recon, q.to(torch.float32) * scale[:, block_of])
        assert torch.equal(new_err, want_err)
        assert torch.equal(bits, torch.sum(q != 0, dim=1).to(torch.float32)
                           * (8.0 + np.ceil(np.log2(d))))


WRAPPERS = {
    "compress_q8": lambda x: kq8.compress_blocks(x, x, 410),
    "quant8": lambda x: kq8.quant8_blocks(x),
    "topk_ef": lambda x: ktk.topk_ef_blocks(x, x, 410),
}


@pytest.mark.parametrize("kernel", list(WRAPPERS))
def test_kernel_wrappers_take_d_at_or_past_two_to_the_31(monkeypatch, kernel):
    """The C entries take d as a 64-bit integer: a row of 2^31 coordinates
    (a stride-0 view stands for it) passes the size check and reaches the
    input checks, which refuse the view for not being contiguous."""
    monkeypatch.setattr(_launch, "require_cuda", lambda t, what: t.device)
    big = torch.zeros((1, 1)).expand(1, 2 ** 31 + 8209)
    with pytest.raises(ValueError, match="contiguous"):
        WRAPPERS[kernel](big)


@pytest.mark.parametrize("kernel", list(WRAPPERS))
@pytest.mark.parametrize("shape", [(2 ** 18, 2 ** 26), (2 ** 31, 1)])
def test_kernel_wrappers_refuse_a_task_count_at_or_past_two_to_the_31(monkeypatch, kernel,
                                                                     shape):
    """A launch takes one task per (row, 8192-block), an int index on the
    card: N x blocks of 2^31 or more raises before anything is launched."""
    monkeypatch.setattr(_launch, "require_cuda", lambda t, what: t.device)
    with pytest.raises(ValueError, match="N x blocks below 2\\^31"):
        WRAPPERS[kernel](torch.zeros((1, 1)).expand(*shape))


@pytest.mark.parametrize("lib_mod,entry,d_at", [(kq8, "compress_q8", 3), (kq8, "quant8", 2),
                                                (ktk, "topk_ef", 3)])
def test_c_entries_take_d_as_a_64_bit_integer(monkeypatch, lib_mod, entry, d_at):
    """The wrappers declare d as ``ctypes.c_int64``, so a d past 2^31
    reaches the C entry whole (a ``c_int`` would wrap it silently)."""
    fake = types.SimpleNamespace(**{name: types.SimpleNamespace() for name in (
        "compress_q8", "quant8", "quant8_error_string", "topk_ef", "topk_ef_error_string")})
    monkeypatch.setattr(lib_mod, "_lib", None)
    monkeypatch.setattr(lib_mod._build, "load", lambda name: fake)
    argtypes = getattr(lib_mod._library(), entry).argtypes
    assert argtypes[d_at] is ctypes.c_int64 and argtypes[d_at - 1] is ctypes.c_int
    assert argtypes[d_at](2 ** 31 + 8209).value == 2 ** 31 + 8209

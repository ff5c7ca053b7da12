"""The reference's ``data`` mesh axis in the port, on the CPU over gloo
ranks (``tests/torch_mesh_ranks.py``).

* Production training: ``models/api.make_train_step(cfg, data=mesh)`` on
  W = 2 ranks, each on its half of the batch, in f32 at lr 1e-2 (dense,
  hybrid, ssm, encdec, vlm and moe REDUCED; the moe with one whole
  ``MOE_GROUP`` of tokens a rank, at lr 1e-1 so that its step, not the
  f32 rounding of the params, is what the rule measures).  Both ranks' new params, losses and
  reduced gradients are the same bits; they equal the one-process step on
  the whole batch at the train-step rule of ``tests/torch_lm_parity.py``
  (every update leaf within 1e-4 of the largest update coordinate, every
  gradient within 1e-4 of the largest gradient coordinate, the loss to
  rtol 1e-5), and for dense and hybrid the reference's
  ``api.make_train_step(cfg)`` on the whole batch at the same rule.  Two
  ranks sum two half-batch gradients where one process sums one, so only
  the f32 rounding of the sum differs.
* MoE dispatch groups that span data ranks (qwen2-moe REDUCED f32 from
  the reference's params, lr 1e-1): 2 ranks x 1,024 tokens and 4 x 512
  (one 2,048-token group over the ranks) and 2 x 3,072 (1.5 groups a
  rank).  The ranks' params, losses and gradients are the same bits, and
  the step equals the one-process step and the reference's step on the
  whole batch at the train-step rule.  The pod step over 2 pods x 2 data
  ranks with a MoE whose pod batch is one group over its two data ranks
  holds the 2-pod loop within the neighbouring-int8-code rule.  A global
  token count past one group that is not whole groups raises.
* ``launch/train.main`` at ``--device cpu`` under 2 ranks: rank 0 alone
  saves, both ranks restore, and its losses equal the one-process run's:
  the first bitwise-close (rtol 1e-6: the same forward, its two halves'
  mean against one mean), the second within 2e-3 relative (the REDUCED
  configs are bf16, and a bf16 param one ulp apart after the first
  update moves the loss by up to about that).
* The pod step over a ``PodDataMesh`` of 2 pods x 2 data ranks (W = 4)
  against 2 pods x 1 (W = 2) and the one-process 2-pod loop, both modes,
  E = 1 and 2: all four ranks' params the same bits, a pod's two data
  ranks' error buffers the same bits, and within the neighbouring-int8-
  code rule of ``tests/test_torch_pod.py`` of the loop.  2 x 1 is the
  loop bitwise, as the one-axis mesh is.
* ``data=None`` and a one-rank mesh give today's bits.
"""
import functools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch_lm_parity as lp
from test_torch_pod import FLIP_SHARE
from torch_mesh_ranks import run_ranks
from torch_parity import one_intra_op_thread  # noqa: F401

from repro.models import api as japi
from repro_torch import configs as tconfigs
from repro_torch.core import mesh_fl
from repro_torch.launch import sharding
from repro_torch.launch import train as tlaunch
from repro_torch.models import api as tapi
from repro_torch.models import moe as tmoe
from repro_torch.optim import sgd as tsgd

LR = 1e-2
W = 2
TIMEOUT_S = 180.0
FAMILIES = {"dense": "llama3-8b", "hybrid": "recurrentgemma-2b", "ssm": "mamba2-2.7b",
            "encdec": "whisper-medium", "vlm": "internvl2-26b", "moe": "qwen2-moe-a2.7b"}
WITH_REFERENCE = ("dense", "hybrid")
MOE_ROWS, MOE_SEQ = 4, tmoe.MOE_GROUP // 2     # 2 rows x 1,024 = one group a rank
MOE_LR = 1e-1
MOE_ARCH = FAMILIES["moe"]
# Capacity a quarter of the even share (256 of a 2,048-token group's 1,024
# choices an expert): tokens are dropped, so a rank's places in a group's
# queue depend on the ranks before it (and the one-hots stay small).
MOE_CAPACITY = 0.25
# Split dispatch groups: case -> (ranks, global batch (rows, seq)).
MOE_SPLITS = {"2x1024": (2, (4, 512)), "4x512": (4, (4, 512)), "2x3072": (2, (12, 512))}
POD_ARCH, POD_B, POD_S, POD_STEPS = "llama3-8b", 4, 16, 2
POD_CASES = [(m, e) for m in ("int8", "topk") for e in (1, 2)]
LAUNCH = ["production", "--arch", "llama3-8b", "--batch", "2", "--seq", "16",
          "--ckpt-every", "1", "--device", "cpu"]


def _port_cfg(arch):
    return tconfigs.get(arch, reduced=True).replace(dtype=torch.float32, learning_rate=LR)


def _inputs(family):
    """(cfg, params, whole batch) of one family's step: the reference's
    params and tokens for dense and hybrid, the port's init otherwise."""
    arch = FAMILIES[family]
    if family in WITH_REFERENCE:
        jcfg, tcfg, _, tp = lp.carry(arch, learning_rate=LR)
        return tcfg, tp, lp.batches(jcfg, s=32, seed=2)[1]
    cfg = _port_cfg(arch)
    if family == "moe":
        # Its gradients at this init are ~10x smaller than the others': at lr
        # 1e-2 one f32 ulp of |p| would be 1.3e-4 of its largest update.
        cfg = cfg.replace(learning_rate=MOE_LR)
    g = torch.Generator().manual_seed(0)
    params = tapi.init_params(g, cfg)
    b, s = (MOE_ROWS, MOE_SEQ) if family == "moe" else (4, 32)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g, dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["audio_embeds"] = torch.randn((b, cfg.n_audio_frames, cfg.d_model), generator=g)
    if cfg.n_visual_tokens:
        batch["visual_embeds"] = torch.randn((b, cfg.n_visual_tokens, cfg.d_model), generator=g)
    return cfg, params, batch


def _pod_inputs():
    cfg = _port_cfg(POD_ARCH)
    g = torch.Generator().manual_seed(0)
    params = tapi.init_params(g, cfg)
    return cfg, params, {"tokens": torch.randint(0, cfg.vocab_size, (POD_B, POD_S), generator=g,
                                                 dtype=torch.int32)}


def _moe_split_inputs(case):
    """(cfg, the port's params from the reference's, whole batch) of a
    split-group case."""
    jcfg, tcfg, _, tp = lp.carry(MOE_ARCH, learning_rate=MOE_LR, capacity_factor=MOE_CAPACITY)
    b, s = MOE_SPLITS[case][1]
    return tcfg, tp, lp.batches(jcfg, b=b, s=s, seed=3)[1]


@functools.lru_cache(maxsize=None)
def _moe_reference_step(b, s):
    """(grad leaves, loss, update leaves) of the reference's step on the
    whole (b, s) batch, as ``lp.ref_train_step`` at ``MOE_LR``."""
    jcfg, _, jp, _ = lp.carry(MOE_ARCH, learning_rate=MOE_LR, capacity_factor=MOE_CAPACITY)
    jb, _ = lp.batches(jcfg, b=b, s=s, seed=3)
    jloss, jgrads = jax.jit(jax.value_and_grad(japi.loss_fn(jcfg)))(jp, jb)
    jp2, _ = jax.jit(japi.make_train_step(jcfg))(jp, jb)
    upd = [np.asarray(a, np.float32) - np.asarray(b, np.float32)
           for a, b in zip(jax.tree.leaves(jp2), jax.tree.leaves(jp))]
    return [np.asarray(g) for g in jax.tree.leaves(jgrads)], float(jloss), upd


@functools.lru_cache(maxsize=None)
def _moe_one_process(case):
    """(grad leaves, loss, update leaves) of the port's one-process step on
    a split case's whole batch (cases with one batch share it)."""
    return _moe_one_process_at(MOE_SPLITS[case][1])


@functools.lru_cache(maxsize=None)
def _moe_one_process_at(shape):
    cfg, params, batch = _moe_split_inputs(next(c for c, (_, b) in MOE_SPLITS.items()
                                                if b == shape))
    grads, _ = tsgd.grad_and_value(tapi.loss_fn(cfg))(params, batch)
    new, loss = tapi.make_train_step(cfg)(params, batch)
    old = _np(tsgd.tree_leaves(params))
    return (_np(tsgd.tree_leaves(grads)), float(loss),
            [n - o for n, o in zip(_np(tsgd.tree_leaves(new)), old)])


def _moe_pod_inputs():
    """A MoE pod step whose pod batch (2 rows x 512) is one dispatch group
    over the pod's two data ranks."""
    cfg = _port_cfg(MOE_ARCH).replace(capacity_factor=MOE_CAPACITY)
    g = torch.Generator().manual_seed(0)
    params = tapi.init_params(g, cfg)
    return cfg, params, {"tokens": torch.randint(0, cfg.vocab_size, (4, 512), generator=g,
                                                 dtype=torch.int32)}


def _pod_loop(cfg, params, batch, mode, local_epochs, steps=POD_STEPS):
    """The one-process 2-pod loop: (param leaves, err leaves (2, ...), losses)."""
    step = mesh_fl.make_pod_hfl_train_step(cfg, None, mode=mode, local_epochs=local_epochs,
                                           n_pods=2)
    err, losses = mesh_fl.init_err(params, 2), []
    for _ in range(steps):
        params, err, loss = step(params, err, batch)
        losses.append(loss)
    return params, err, torch.stack(losses)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of W = 2 gloo ranks: every family's step, the moe split,
    the launcher twice on one checkpoint directory and with a batch the
    ranks do not divide, the pod step over 2 pods x 1 data rank, and the
    mesh layouts."""
    tmp = tmp_path_factory.mktemp("data_axis_w2")
    jobs = [("step",) + _inputs(f) + (1,) for f in FAMILIES]
    splits = [c for c, (w, _) in MOE_SPLITS.items() if w == W]
    jobs += [("step",) + _moe_split_inputs(c) + (1,) for c in splits]
    ckpt = str(tmp / "ckpt")
    jobs += [("launch", LAUNCH + ["--steps", "2", "--ckpt-dir", ckpt]),
             ("launch", LAUNCH + ["--steps", "1", "--ckpt-dir", ckpt]),
             ("launch", LAUNCH[:3] + ["--batch", "3"] + LAUNCH[5:] + ["--steps", "1"])]
    pcfg, pparams, pbatch = _pod_inputs()
    jobs += [("pod_data", pcfg, pparams, pbatch, dict(mode=m, local_epochs=e), POD_STEPS, 1)
             for m, e in POD_CASES]
    jobs += [("layout", 1), ("layout", 2)]
    ranks = run_ranks(jobs, W, tmp / "ranks", timeout_s=TIMEOUT_S)
    names = [f"step:{f}" for f in FAMILIES] + [f"split:{c}" for c in splits]
    names += ["launch", "resume", "ragged"]
    names += [f"pod:{m}:{e}" for m, e in POD_CASES] + ["layout:1", "layout:2"]
    return [dict(zip(names, r)) for r in ranks], tmp


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One spawn of W = 4 gloo ranks: the pod step over 2 pods x 2 data
    ranks in every case, the MoE pod step at a split group, the MoE step at
    one group over the four ranks, and the layouts."""
    pcfg, pparams, pbatch = _pod_inputs()
    jobs = [("pod_data", pcfg, pparams, pbatch, dict(mode=m, local_epochs=e), POD_STEPS, 2)
            for m, e in POD_CASES]
    jobs.append(("pod_data",) + _moe_pod_inputs() + (dict(mode="int8"), 1, 2))
    splits = [c for c, (w, _) in MOE_SPLITS.items() if w == 4]
    jobs += [("step",) + _moe_split_inputs(c) + (1,) for c in splits]
    jobs += [("layout", 2), ("layout", 4)]
    ranks = run_ranks(jobs, 4, tmp_path_factory.mktemp("data_axis_w4") / "ranks",
                      timeout_s=TIMEOUT_S)
    names = [f"pod:{m}:{e}" for m, e in POD_CASES] + ["pod:moe"]
    names += [f"split:{c}" for c in splits] + ["layout:2", "layout:4"]
    return [dict(zip(names, r)) for r in ranks]


def _assert_rule(got, want, what):
    """Every leaf within 1e-4 of the largest coordinate over all leaves of
    ``want`` (f32 numpy lists)."""
    top = max(float(np.abs(w).max()) for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, f"{what} leaf {i}"
        err = float(np.abs(g - w).max())
        assert err <= 1e-4 * top, f"{what} leaf {i}: {err:.3e} > 1e-4 * {top:.3e}"


def _np(leaves):
    return [lp.t2np(t) for t in leaves]


# --- production training -----------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_ranks_are_bitwise_equal(two_ranks, family):
    ranks, _ = two_ranks
    a, b = ranks[0][f"step:{family}"], ranks[1][f"step:{family}"]
    for key in ("params", "grads"):
        assert all(torch.equal(x, y) for x, y in zip(a[key], b[key])), key
    assert torch.equal(a["losses"], b["losses"])
    assert all(g.dtype == torch.float32 for g in a["grads"])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_data_ranks_equal_one_process_on_the_whole_batch(two_ranks, family):
    ranks, _ = two_ranks
    got = ranks[0][f"step:{family}"]
    cfg, params, batch = _inputs(family)
    grads, _ = tsgd.grad_and_value(tapi.loss_fn(cfg))(params, batch)
    new, loss = tapi.make_train_step(cfg)(params, batch)
    np.testing.assert_allclose(float(got["losses"][0]), float(loss), rtol=1e-5)
    _assert_rule(_np(got["grads"]), _np(tsgd.tree_leaves(grads)), "gradient")
    old = _np(tsgd.tree_leaves(params))
    _assert_rule([g - o for g, o in zip(_np(got["params"]), old)],
                 [n - o for n, o in zip(_np(tsgd.tree_leaves(new)), old)], "update")


@pytest.mark.parametrize("family", WITH_REFERENCE)
def test_data_ranks_equal_the_reference_step_on_the_whole_batch(two_ranks, family):
    ranks, _ = two_ranks
    got = ranks[0][f"step:{family}"]
    jg, jl, want = lp.ref_train_step(FAMILIES[family], 32)
    np.testing.assert_allclose(float(got["losses"][0]), jl, rtol=1e-5)
    _assert_rule(_np(got["grads"]), jg, "gradient")
    _, _, _, tp = lp.carry(FAMILIES[family], learning_rate=LR)
    old = _np(tsgd.tree_leaves(tp))
    _assert_rule([g - o for g, o in zip(_np(got["params"]), old)], want, "update")


# --- MoE dispatch groups over data ranks ---------------------------------------------

def _split_ranks(two_ranks, four_ranks, case):
    return (two_ranks[0] if MOE_SPLITS[case][0] == W else four_ranks)


@pytest.mark.parametrize("case", list(MOE_SPLITS))
def test_split_moe_group_ranks_are_bitwise_equal(two_ranks, four_ranks, case):
    ranks = _split_ranks(two_ranks, four_ranks, case)
    first = ranks[0][f"split:{case}"]
    for r in ranks[1:]:
        got = r[f"split:{case}"]
        for key in ("params", "grads"):
            assert all(torch.equal(x, y) for x, y in zip(got[key], first[key])), key
        assert torch.equal(got["losses"], first["losses"])


@pytest.mark.parametrize("case", list(MOE_SPLITS))
def test_split_moe_group_equals_one_process_on_the_whole_batch(two_ranks, four_ranks, case):
    got = _split_ranks(two_ranks, four_ranks, case)[0][f"split:{case}"]
    grads, loss, update = _moe_one_process(case)
    np.testing.assert_allclose(float(got["losses"][0]), loss, rtol=1e-5)
    _assert_rule(_np(got["grads"]), grads, "gradient")
    _, params, _ = _moe_split_inputs(case)
    old = _np(tsgd.tree_leaves(params))
    _assert_rule([g - o for g, o in zip(_np(got["params"]), old)], update, "update")


@pytest.mark.parametrize("case", list(MOE_SPLITS))
def test_split_moe_group_equals_the_reference_step_on_the_whole_batch(two_ranks, four_ranks,
                                                                      case):
    got = _split_ranks(two_ranks, four_ranks, case)[0][f"split:{case}"]
    jg, jl, want = _moe_reference_step(*MOE_SPLITS[case][1])
    np.testing.assert_allclose(float(got["losses"][0]), jl, rtol=1e-5)
    _assert_rule(_np(got["grads"]), jg, "gradient")
    _, params, _ = _moe_split_inputs(case)
    old = _np(tsgd.tree_leaves(params))
    _assert_rule([g - o for g, o in zip(_np(got["params"]), old)], want, "update")


@pytest.mark.parametrize("ranks,tokens,want", [
    (2, 1024, (2048, [(0, 1024)])),                   # one group over two ranks
    (4, 512, (2048, [(0, 512)])),
    (2, 3072, (2048, [(0, 1024), (1024, 3072)])),     # rank 1: half a group, then one
    (2, 512, (1024, [(0, 512)])),                     # a global batch under one group
])
def test_data_split_parts_of_the_global_groups(ranks, tokens, want):
    split = tmoe.data_split(tokens, sharding.ClientMesh(None, ranks - 1, ranks))
    assert (split.g_size, split.parts()) == want
    first, n = split.span(0)
    assert first == 0 and sum(b - a for a, b in split.parts()) == tokens
    assert n == len(tmoe.data_split(tokens, sharding.ClientMesh(None, 0, ranks)).parts())


def test_whole_groups_a_rank_and_one_rank_keep_todays_step():
    """No split: no mesh, one rank, or a rank's tokens whole groups."""
    assert tmoe.data_split(100, None) is None
    assert tmoe.data_split(100, sharding.ClientMesh(None, 0, 1)) is None
    assert tmoe.data_split(2 * tmoe.MOE_GROUP, sharding.ClientMesh(None, 1, 2)) is None


def test_a_global_token_count_that_is_not_whole_groups_raises():
    """Past one group the global count must be whole groups (the
    reference's reshape); the step raises before any collective."""
    mesh = sharding.ClientMesh(None, 0, 2)
    with pytest.raises(ValueError, match="3072 tokens over 2 data ranks"):
        tmoe.data_split(1536, mesh)
    cfg, params, _ = _moe_split_inputs("2x3072")
    mine = {"tokens": torch.zeros((1, 1536), dtype=torch.int32)}     # 1,536 a rank
    with pytest.raises(ValueError, match="whole number"):
        tapi.make_train_step(cfg, mesh)(params, mine)


# --- the launcher ------------------------------------------------------------------

def test_launcher_rank_zero_alone_saves_and_both_restore(two_ranks):
    ranks, tmp = two_ranks
    assert ranks[0]["launch"]["saves"] == [1, 2, 2] and ranks[1]["launch"]["saves"] == []
    for r in range(W):
        out = ranks[r]["launch"]["out"]
        assert out["data_ranks"] == W and out["rank"] == r and out["start"] == 0
        assert ranks[r]["resume"]["out"]["start"] == 2
    assert ranks[0]["launch"]["out"]["losses"] == ranks[1]["launch"]["out"]["losses"]
    assert tlaunch.CheckpointStore(str(tmp / "ckpt")).latest_step() == 3


def test_launcher_losses_equal_the_one_process_run(two_ranks, tmp_path, capsys):
    ranks, _ = two_ranks
    want = tlaunch.main(LAUNCH + ["--steps", "2", "--ckpt-dir", str(tmp_path)])
    assert "data_ranks" in capsys.readouterr().out
    got = ranks[0]["launch"]["out"]["losses"]
    assert want["data_ranks"] == 1
    np.testing.assert_allclose(got[0], want["losses"][0], rtol=1e-6)
    np.testing.assert_allclose(got[1], want["losses"][1], rtol=2e-3)


def test_launcher_refuses_a_batch_the_ranks_do_not_divide(two_ranks):
    ranks, _ = two_ranks
    for r in range(W):
        assert "does not split over 2 data ranks" in ranks[r]["ragged"]["raised"]


# --- the two-axis mesh --------------------------------------------------------------

def test_pod_data_mesh_layout(two_ranks, four_ranks):
    """rank = p D + r: the data group is pod p's D ranks, the pod group
    data index r's ranks across the pods."""
    for world, ranks, d_list in ((W, two_ranks[0], (1, 2)), (4, four_ranks, (2, 4))):
        for d in d_list:
            for g, r in enumerate(ranks):
                lay = r[f"layout:{d}"]
                p, i = divmod(g, d)
                assert lay["pod"] == (p, world // d) and lay["data"] == (i, d)
                assert lay["shape"] == {"pod": world // d, "data": d}
                assert lay["data_sum"] == sum(range(p * d, (p + 1) * d))
                assert lay["pod_sum"] == sum(range(i, world, d))
                assert lay["data_mean"].dtype == torch.float32
                assert float(lay["data_mean"]) == sum(range(p * d, (p + 1) * d)) / d


def test_pod_data_mesh_refuses_an_uneven_split(monkeypatch):
    monkeypatch.setattr(sharding, "client_mesh", lambda group=None: sharding.ClientMesh(None, 0, 4))
    with pytest.raises(ValueError, match="3 data ranks"):
        sharding.pod_data_mesh(3)


# --- the pod step over (pod, data) ----------------------------------------------------

def _assert_close_but_flips(got, want, step, what):
    diff = (got - want).abs()
    far = diff > 1e-5
    if bool(far.any()):
        assert bool((diff[far] <= 1.001 * step + 1e-5).all()), f"{what}: beyond one step"
        assert int(far.sum()) <= max(2, FLIP_SHARE * got.numel()), f"{what}: {int(far.sum())}"


@pytest.mark.parametrize("mode,local_epochs", POD_CASES)
def test_pod_step_two_by_one_is_the_loop_bitwise(two_ranks, mode, local_epochs):
    ranks, _ = two_ranks
    cfg, params, batch = _pod_inputs()
    want_p, want_e, want_l = _pod_loop(cfg, params, batch, mode, local_epochs)
    for r in range(W):
        got = ranks[r][f"pod:{mode}:{local_epochs}"]
        assert torch.equal(got["params"], tsgd.ravel_tree(want_p))
        assert torch.equal(got["err"], tsgd.ravel_tree([e[r] for e in tsgd.tree_leaves(want_e)]))
        assert torch.equal(got["losses"], want_l)


@pytest.mark.parametrize("mode,local_epochs", POD_CASES)
def test_pod_step_two_by_two(two_ranks, four_ranks, mode, local_epochs):
    key = f"pod:{mode}:{local_epochs}"
    first = four_ranks[0][key]
    for r in range(4):
        assert torch.equal(four_ranks[r][key]["params"], first["params"]), r
        assert torch.equal(four_ranks[r][key]["losses"], first["losses"]), r
    for p in range(2):    # a pod's two data ranks hold the same error buffers
        assert torch.equal(four_ranks[2 * p][key]["err"], four_ranks[2 * p + 1][key]["err"])
    cfg, params, batch = _pod_inputs()
    want_p, want_e, want_l = _pod_loop(cfg, params, batch, mode, local_epochs)
    np.testing.assert_allclose(first["losses"].numpy(), want_l.numpy(), rtol=1e-5)
    off = 0
    for leaf, e in zip(tsgd.tree_leaves(want_p), tsgd.tree_leaves(want_e)):
        n = leaf.numel()
        qstep = float(e.abs().max()) * 2 + 1e-30
        _assert_close_but_flips(first["params"][off:off + n], leaf.reshape(-1),
                                qstep * (LR if local_epochs == 1 else 1.0), f"params {key}")
        for p in range(2):
            _assert_close_but_flips(four_ranks[2 * p][key]["err"][off:off + n], e[p].reshape(-1),
                                    qstep, f"err {key} pod {p}")
        off += n
    assert off == first["params"].numel()
    two_by_one = two_ranks[0][0][key]
    assert torch.equal(two_by_one["params"], tsgd.ravel_tree(want_p))


def test_moe_pod_step_at_a_split_group(four_ranks):
    """One step of 2 pods x 2 data ranks, each pod's 1,024 tokens one
    dispatch group over its two ranks: every rank's params the same bits,
    a pod's ranks' error buffers the same bits, and the 2-pod loop within
    neighbouring int8 codes."""
    first = four_ranks[0]["pod:moe"]
    for r in range(4):
        assert torch.equal(four_ranks[r]["pod:moe"]["params"], first["params"]), r
    for p in range(2):
        assert torch.equal(four_ranks[2 * p]["pod:moe"]["err"],
                           four_ranks[2 * p + 1]["pod:moe"]["err"])
    cfg, params, batch = _moe_pod_inputs()
    want_p, want_e, want_l = _pod_loop(cfg, params, batch, "int8", 1, steps=1)
    np.testing.assert_allclose(first["losses"].numpy(), want_l.numpy(), rtol=1e-5)
    off = 0
    for leaf, e in zip(tsgd.tree_leaves(want_p), tsgd.tree_leaves(want_e)):
        n = leaf.numel()
        qstep = float(e.abs().max()) * 2 + 1e-30
        _assert_close_but_flips(first["params"][off:off + n], leaf.reshape(-1), qstep * LR,
                                "moe params")
        for p in range(2):
            _assert_close_but_flips(four_ranks[2 * p]["pod:moe"]["err"][off:off + n],
                                    e[p].reshape(-1), qstep, f"moe err pod {p}")
        off += n
    assert off == first["params"].numel()


# --- no mesh, one rank --------------------------------------------------------------

@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group in this process, taken down after the test."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        yield sharding.client_mesh()
    finally:
        dist.destroy_process_group()


def test_a_one_rank_data_mesh_is_todays_step_bitwise(one_rank):
    cfg, params, batch = _inputs("moe")
    batch = {k: v[:1, :64] for k, v in batch.items()}      # one rank: any token count
    for data in (None, one_rank):
        got = tapi.make_train_step(cfg, data)(params, batch)
        want = tapi.make_train_step(cfg)(params, batch)
        assert torch.equal(got[1], want[1])
        assert all(torch.equal(a, b) for a, b in zip(tsgd.tree_leaves(got[0]),
                                                      tsgd.tree_leaves(want[0])))
    g1, l1 = tsgd.grad_and_value(tapi.loss_fn(cfg, one_rank), one_rank)(params, batch)
    g0, l0 = tsgd.grad_and_value(tapi.loss_fn(cfg))(params, batch)
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(tsgd.tree_leaves(g1), tsgd.tree_leaves(g0)))


def test_mean_is_an_f32_sum_over_the_group(one_rank):
    x = torch.tensor([1.5, -2.25], dtype=torch.bfloat16)
    got = one_rank.mean_(x)
    assert got.dtype == torch.float32 and torch.equal(got, x.float())
    y = torch.tensor([3.0, 4.0])
    assert one_rank.mean_(y) is y


def test_a_one_axis_pod_mesh_is_a_pod_data_mesh_of_one(one_rank):
    """With one rank, ``pod_data_mesh(1)`` is the default group on the pod
    axis and a mesh of one on the data axis; the step is the ClientMesh's
    bit for bit."""
    pdm = sharding.pod_data_mesh(1)
    assert pdm.pod.group is None and pdm.data.size == 1 and pdm.axis_names == ("pod", "data")
    cfg, params, batch = _pod_inputs()
    outs = []
    for mesh in (one_rank, pdm):
        step = mesh_fl.make_pod_hfl_train_step(cfg, mesh, local_epochs=2)
        outs.append(step(params, mesh_fl.init_err(params), batch))
    for a, b in zip(*(tsgd.tree_leaves(o[0]) + tsgd.tree_leaves(o[1]) + [o[2]] for o in outs)):
        assert torch.equal(a, b)

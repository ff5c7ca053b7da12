"""The port's launch tooling against the JAX package on the CPU: the
logical-axis rules (``launch/sharding``), each family's axes and cache
axes, the dry run's abstract params, caches and inputs (``models/api``),
the roofline's model FLOPs, and the dry run itself.

The reference's ``resolve_spec`` reads only ``.shape`` and ``.axis_names``
of its mesh, as ``tests/test_sharding.py``'s ``FakeMesh`` gives them; the
port's ``AbstractMesh`` is held to it on the production meshes.  Shapes
and dtypes of the reference come from ``jax.eval_shape`` at full size (no
allocation on either side).  Specs, shapes, dtypes, reasons and FLOP
counts are compared exactly.
"""
import functools
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch_parity import one_intra_op_thread  # noqa: F401

from repro import configs as jconfigs
from repro.launch import roofline as jroofline
from repro.launch import sharding as jsh
from repro.models import api as japi
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, mesh as tmesh, roofline
from repro_torch.launch import sharding as sh
from repro_torch.models import api as tapi
from repro_torch.models import layers as L


class FakeMesh:
    def __init__(self, shape_map):
        self.shape = dict(shape_map)
        self.axis_names = tuple(shape_map)


POD_MESH = FakeMesh({"data": 16, "model": 16})
MULTI_MESH = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"pod": (POD_MESH, tmesh.make_production_mesh()),
          "multipod": (MULTI_MESH, tmesh.make_production_mesh(multi_pod=True))}
ARCHS = tconfigs.model_archs()
SHAPES = tuple(tconfigs.SHAPES)


# --- the rules: every case of tests/test_sharding.py, on both meshes' twins ---

RULE_CASES = [
    (("embed", "ff"), (4096, 14336)),
    (("batch", None), (256, 4096)),
    (("embed", "heads", "head_dim"), (5120, 40, 128)),
    (("ff", "vocab"), (65536, 65536)),
    (("vocab", "ff"), (151936, 17408)),
    (None, (7, 3)),
    (("vocab", "embed"), (128256, 4096)),
    (("kv_heads", "head_dim"), (8, 128)),
    (("experts", "embed", "ff"), (64, 2048, 1408)),
    (("batch", "seq_shard", "heads", None), (32, 32768, 40, 128)),
    (("layers", "batch", "cache_seq", "kv_heads", "head_dim"), (40, 128, 32768, 8, 128)),
    (("batch",), (8,)),
    ((), ()),
]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("logical,shape", RULE_CASES)
def test_resolve_spec_matches_the_reference(mesh_name, logical, shape):
    fake, abstract = MESHES[mesh_name]
    want = jsh.resolve_spec(logical, shape, fake)
    got = sh.resolve_spec(logical, shape, abstract)
    assert got == want
    assert isinstance(got, tuple) and len(got) == (0 if logical is None else len(shape))


def test_resolve_spec_reference_cases():
    """The assertions of tests/test_sharding.py on the port."""
    pod, multi = tmesh.make_production_mesh(), tmesh.make_production_mesh(multi_pod=True)
    assert sh.resolve_spec(("embed", "ff"), (4096, 14336), pod) == P("data", "model")
    assert sh.resolve_spec(("batch", None), (256, 4096), pod) == P("data", None)
    assert sh.resolve_spec(("batch", None), (256, 4096), multi) == P(("pod", "data"), None)
    spec = sh.resolve_spec(("embed", "heads", "head_dim"), (5120, 40, 128), pod)
    assert spec[1] is None and spec[2] == "model"
    axes = [s for s in sh.resolve_spec(("ff", "vocab"), (65536, 65536), pod) if s is not None]
    assert len(axes) == len(set(axes)) and "model" in axes
    assert sh.resolve_spec(("vocab", "ff"), (151936, 17408), pod)[1] == "model"
    assert sh.resolve_spec(None, (7, 3), pod) == P()
    for logical, shape in [(("embed", "ff"), (4096, 14336)), (("vocab", "embed"), (128256, 4096)),
                           (("kv_heads", "head_dim"), (8, 128))]:
        spec = sh.resolve_spec(logical, shape, multi)
        flat = [a for s in spec if s is not None for a in (s if isinstance(s, tuple) else (s,))]
        assert "pod" not in flat
    spec = sh.resolve_spec(("experts", "embed", "ff"), (64, 2048, 1408), pod)
    assert spec[2] == "model" or spec[0] == "model"
    with pytest.raises(ValueError, match="do not match"):
        sh.resolve_spec(("embed",), (4, 4), pod)


def test_batch_shardings_match_the_reference():
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jspecs = {"tokens": jax.ShapeDtypeStruct((8, 128), jnp.int32),
              "audio_embeds": jax.ShapeDtypeStruct((8, 1500, 64), jnp.bfloat16)}
    want = {k: v.spec for k, v in jsh.batch_shardings(jspecs, jmesh).items()}
    tspecs = {k: torch.empty(v.shape, device="meta") for k, v in jspecs.items()}
    assert sh.batch_shardings(tspecs, tmesh.make_host_mesh()) == want
    assert want["tokens"] == P("data", None)
    for name, (fake, abstract) in MESHES.items():
        want = {k: jsh.resolve_spec(("batch",) + (None,) * (len(v.shape) - 1), v.shape, fake)
                for k, v in jspecs.items()}
        assert sh.batch_shardings(tspecs, abstract) == want, name


def test_meshes_and_constants():
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert tmesh.make_host_mesh().shape == {"data": 1, "model": 1}
    assert tmesh.make_federated_mesh(multi_pod=True) == multi
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.PEAK_FLOPS_F32, tmesh.HBM_BW, tmesh.NVLINK_BW) == (
        989.4e12, 67e12, 3.35e12, 450e9)
    with pytest.raises(ValueError):
        tmesh.AbstractMesh(("data", "data"), (2, 2))
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.device_mesh(tmesh.make_host_mesh())


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    dm = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert sh.to_placements((("pod", "data"), None, "model"), dm) == (Shard(0), Shard(0), Shard(2))
    assert sh.to_placements(("data", None), dm) == (Replicate(), Shard(0), Replicate())
    assert sh.to_placements((), dm) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="lacks"):
        sh.to_placements(("model",), SimpleNamespace(mesh_dim_names=("data",)))


# --- axes, abstract params / caches / inputs, per arch ---------------------

def same_tree(port, ref, path="") -> None:
    """The port's tree equals the reference's: NamedTuples of the same class
    name and fields, equal leaves (axis tuples, or None)."""
    if hasattr(ref, "_fields"):
        assert type(port).__name__ == type(ref).__name__ and port._fields == ref._fields, path
        for f in ref._fields:
            same_tree(getattr(port, f), getattr(ref, f), f"{path}.{f}")
    elif isinstance(ref, tuple) and any(isinstance(e, tuple) for e in ref):
        assert isinstance(port, tuple) and len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            same_tree(p, r, f"{path}[{i}]")
    else:
        assert port == ref, path


@functools.lru_cache(maxsize=None)
def jax_abstract(arch: str):
    return japi.abstract_params(jconfigs.get(arch))


@functools.lru_cache(maxsize=None)
def port_abstract(arch: str):
    return tapi.abstract_params(tconfigs.get(arch))


def jax_axes_pairs(abstract, axes_tree):
    """The reference's pairing of leaves and logical tuples
    (``launch/sharding.tree_shardings``)."""
    def is_leaf(x):
        return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)
    return list(zip(jax.tree_util.tree_leaves(abstract),
                    jax.tree_util.tree_flatten(axes_tree, is_leaf=is_leaf)[0]))


def dtype_name(d) -> str:
    return str(d).removeprefix("torch.")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_match_the_reference(arch):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    same_tree(tapi.param_axes(tcfg), japi.param_axes(jcfg))
    mod_t, mod_j = tapi.module(tcfg), japi.module(jcfg)
    assert hasattr(mod_t, "cache_axes") == hasattr(mod_j, "cache_axes")
    if hasattr(mod_j, "cache_axes"):
        same_tree(mod_t.cache_axes(tcfg), mod_j.cache_axes(jcfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_eval_shape(arch):
    got = L.leaves(port_abstract(arch))
    want = jax.tree_util.tree_leaves(jax_abstract(arch))
    assert [(tuple(t.shape), dtype_name(t.dtype)) for t in got] == [
        (tuple(a.shape), str(a.dtype)) for a in want]
    assert all(t.device.type == "meta" for t in got)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_specs_match_the_reference(arch, mesh_name):
    fake, abstract_mesh = MESHES[mesh_name]
    tcfg = tconfigs.get(arch)
    pairs = jax_axes_pairs(jax_abstract(arch), japi.param_axes(jconfigs.get(arch)))
    want = [jsh.resolve_spec(logical, a.shape, fake) for a, logical in pairs]
    specs = sh.tree_shardings(port_abstract(arch), tapi.param_axes(tcfg), abstract_mesh)
    got = [spec for _, spec in dryrun._pairs(port_abstract(arch), specs)]
    assert got == want


def test_tree_shardings_rejects_a_mismatch():
    cfg = tconfigs.get("llama3-8b", reduced=True)
    params = tapi.abstract_params(cfg)
    axes = tapi.param_axes(cfg)
    mesh = tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="absent leaf"):
        sh.tree_shardings(params._replace(unembed=None), axes, mesh)
    with pytest.raises(ValueError, match="not a logical-axes tuple"):
        sh.tree_shardings(params, axes._replace(final_norm=None), mesh)
    # A block of axes is a node, not one leaf, even where every field is a tuple.
    assert not sh.is_axes_leaf(axes.blocks.attn) and sh.is_axes_leaf(axes.embed)


@pytest.mark.parametrize("arch", ARCHS)
def test_supports_shape_caches_and_inputs_match_the_reference(arch):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    for name in SHAPES:
        jshape, tshape = jconfigs.SHAPES[name], tconfigs.SHAPES[name]
        ok = tapi.supports_shape(tcfg, tshape)
        assert ok == japi.supports_shape(jcfg, jshape), name
        if not ok[0]:
            continue
        want = japi.input_specs(jcfg, jshape)
        got = tapi.input_specs(tcfg, tshape)
        assert {k: (tuple(v.shape), dtype_name(v.dtype)) for k, v in got.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}, name
        if tshape.kind != "decode":
            continue
        long_ctx = name == "long_500k"
        jc = japi.abstract_cache(jcfg, jshape.global_batch, jshape.seq_len, long_ctx)
        tc = tapi.abstract_cache(tcfg, tshape.global_batch, tshape.seq_len, long_ctx)
        assert [(tuple(t.shape), dtype_name(t.dtype)) for t in L.leaves(tc)] == [
            (tuple(a.shape), str(a.dtype)) for a in jax.tree_util.tree_leaves(jc)], name
        assert all(t.device.type == "meta" for t in L.leaves(tc))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_the_reference(arch):
    for name in SHAPES:
        assert roofline.model_flops(arch, name) == jroofline.model_flops(arch, name)


def test_analyse_and_table_use_the_h100_constants():
    rec = {"arch": "llama3_8b", "shape": "train_4k", "mesh": [16, 16], "chips": 256,
           "status": "ok", "dtype": "bfloat16", "flops": 4.0e14, "bytes_accessed": 2.0e12,
           "collectives": {"total": 9.0e9}, "memory": {"peak_bytes": None},
           "model_flops": roofline.model_flops("llama3_8b", "train_4k")}
    row = roofline.analyse(rec)
    assert row["t_compute_s"] == 4.0e14 / 989.4e12 and row["peak"] == "bf16"
    assert row["t_memory_s"] == 2.0e12 / 3.35e12
    assert row["t_collective_s"] == 9.0e9 / 450e9
    assert row["dominant"] == "memory" and row["bound_s"] == row["t_memory_s"]
    assert row["useful_ratio"] == (rec["model_flops"] / 256) / 4.0e14
    f32 = roofline.analyse({**rec, "dtype": "float32"})
    assert f32["t_compute_s"] == 4.0e14 / 67e12 and f32["peak"] == "f32"
    assert f32["dominant"] == "compute"
    text = roofline.table([row, f32])
    assert "llama3_8b" in text and "memory" in text and "compute" in text and " f32 " in text
    assert roofline.analyse({"status": "skipped"}) is None
    assert [roofline.fmt_s(x) for x in (2.0, 2e-3, 2e-6)] == ["   2.00s ", "   2.00ms",
                                                               "    2.0us"]


# --- shard hints ------------------------------------------------------------

def test_shard_hint_resolves_against_the_ambient_mesh():
    x = torch.zeros(4, 3, 8)
    assert L.shard_hint(x, ("batch", None)) is x          # no mesh: untouched, unchecked
    with sh.use_mesh(tmesh.make_host_mesh()) as scope:    # one device: nothing resolved
        assert L.shard_hint(x, ("batch", None)) is x
    assert scope.hints == 0
    with sh.use_mesh(tmesh.make_production_mesh()) as scope:
        assert L.shard_hint(x, ("batch", None, "ff")) is x
        with pytest.raises(ValueError, match="do not match"):
            L.shard_hint(x, ("batch", None))
    assert scope.hints == 1 and sh.ambient() is None


# --- the dry run ---------------------------------------------------------------

FAMILY_ARCHS = ("llama3-8b", "internvl2-26b", "qwen2-moe-a2.7b", "mamba2-2.7b",
                "recurrentgemma-2b", "whisper-medium")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_dryrun_one_reduced(arch):
    cfg = tconfigs.get(arch, reduced=True)
    shape = ShapeConfig("tiny_train", 32, 2, "train")
    rec = dryrun.dryrun_one(arch, shape.name, cfg=cfg, shape=shape, mesh=tmesh.make_host_mesh())
    row = roofline.analyse(rec)
    assert rec["status"] == "ok" and rec["chips"] == 1 and 0.0 < row["useful_ratio"] <= 1.0
    params = L.leaves(tapi.abstract_params(cfg))
    inputs = tapi.input_specs(cfg, shape).values()
    leaf_bytes = sum(t.numel() * t.element_size() for t in [*params, *inputs])
    assert rec["memory"]["argument_bytes"] == leaf_bytes
    assert rec["param_bytes"] == sum(t.numel() * t.element_size() for t in params)
    assert rec["memory"]["output_bytes"] == rec["param_bytes"] + 4     # new params, the loss
    assert rec["memory"]["peak_bytes"] >= leaf_bytes
    assert rec["collectives"]["total"] == 0.0 and rec["collectives"]["source"] == "plan"
    assert rec["flops"] > 0 and rec["bytes_accessed"] > leaf_bytes
    assert rec["corrected"]["flops"] == rec["flops"]
    planned = dryrun.dryrun_one(arch, shape.name, cfg=cfg, shape=shape)   # 16 x 16
    assert planned["flops"] == rec["flops"] / 256
    assert planned["memory"]["peak_bytes"] is None
    assert planned["memory"]["argument_bytes"] < leaf_bytes
    assert planned["collectives"]["all-gather"] > 0 and planned["collectives"]["reduce-scatter"] > 0
    assert (planned["shard_hints"] > 0) == (cfg.family != "ssm")


def test_dryrun_and_roofline_clis(tmp_path, capsys):
    out = tmp_path / "dryrun"
    dryrun.main(["--arch", "llama3-8b", "--shape", "decode_32k", "--out", str(out)])
    rec = json.loads((out / "llama3_8b__decode_32k__pod.json").read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256 and rec["kind"] == "decode"
    assert rec["memory"]["argument_bytes"] > 0 and rec["collectives"]["all-gather"] > 0
    assert rec["model_flops"] == jroofline.model_flops("llama3_8b", "decode_32k")
    capsys.readouterr()
    roofline.main(["--dir", str(out)])
    text = capsys.readouterr().out
    row = roofline.load_all(str(out))[0]
    assert "llama3_8b" in text and "decode_32k" in text and row["peak"] == "bf16"
    assert row["t_compute_s"] > 0 and row["t_memory_s"] > 0 and row["t_collective_s"] > 0
    dryrun.main(["--arch", "llama3-8b", "--shape", "long_500k", "--out", str(out)])
    skipped = json.loads((out / "llama3_8b__long_500k__pod.json").read_text())
    assert skipped["status"] == "skipped" and "long_500k" in skipped["reason"]

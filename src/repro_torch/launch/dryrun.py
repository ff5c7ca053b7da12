"""Dry run of the language models: one train, prefill or serve step of
every (architecture x input shape) planned on a production mesh, with
nothing allocated, and its FLOPs, bytes, memory and collectives written
for the roofline (``launch/roofline``); the port of ``repro.launch.dryrun``.

The reference lowers each step through XLA against a 16 x 16 TPU mesh and
reads the compiled module's analyses.  Here the step is the port's own
(``models/api.make_train_step`` / ``make_prefill_step`` /
``make_serve_step``), run once on the abstract params
(``api.abstract_params``) inside one ``FakeTensorMode`` on the CPU device:
every op computes shapes only, and the kernel dispatch takes the plain
versions, which compute the same functions (a fake ``cuda`` tensor would
hand the kernels' ctypes wrappers a pointer to nothing).  The mesh is a
plan (``launch/mesh.AbstractMesh``): specs from ``launch/sharding``, the
activation hints (``layers.shard_hint``) resolved against it.  A record:

  flops          ``torch.utils.flop_counter.FlopCounterMode`` over the whole
                 step (recomputation under ``cfg.remat`` included), divided
                 by the chips: a per-device figure.  The layers are a Python
                 loop, so every layer is counted and ``corrected`` equals
                 the raw counts (the reference extrapolates its rolled
                 scans; ``configs/base`` has no ``scan_unroll``).
  bytes_accessed the input and output bytes of every aten op that moves
                 data (views, aliases and bare allocations excluded),
                 summed and divided by the chips: unfused traffic, an upper
                 bound on what the card reads and writes.
  memory         ``argument_bytes`` / ``output_bytes`` per device, exact
                 from the specs (a leaf's bytes over the product of the
                 mesh axes its spec names; an output with no sharding of
                 its own, such as the loss or the logits, takes the batch
                 rule); ``peak_bytes``, on a one-device plan only, the
                 largest sum of live fake storages during the step;
                 ``temp_bytes`` is null.
  collectives    ``"source": "plan"``: the bytes per device that the
                 parameter sharding moves in a step, ring factor 1: each
                 leaf sharded over ``data`` is all-gathered for the forward
                 (again for the backward under ``cfg.remat``) and its
                 gradient reduce-scattered; a gradient replicated over a
                 batch axis (``data``, or ``pod``) is all-reduced over it.
                 Activation collectives on the ``model`` axis are not
                 counted: PyTorch has no SPMD partitioner to place them.
  compile_s      seconds of the fake-tensor run.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.launch import roofline
from repro_torch.launch import sharding as shlib
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.models import api
from repro_torch.models import layers as L

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")
NOT_COUNTED = ("activation collectives on the model axis (PyTorch has no SPMD "
               "partitioner to place them)")


# aten ops that allocate or alias without moving data (beside the views
# their schemas mark).
NO_TRAFFIC = frozenset(("_unsafe_view", "alias", "lift_fresh", "empty", "empty_like",
                        "empty_strided", "new_empty", "new_empty_strided"))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def moves_data(func) -> bool:
    """Whether an op's inputs and outputs count as traffic: an aten op
    that is not a view, an alias or an allocation (``prim`` metadata
    queries such as ``device`` move nothing either)."""
    return (func.namespace == "aten" and not func.is_view
            and func.overloadpacket.__name__ not in NO_TRAFFIC)


class Traffic(TorchDispatchMode):
    """Sums the input and output bytes of every op that moves data
    (:func:`moves_data`; an in-place op's operand counts as read and
    written) in ``bytes`` and, with ``track_peak``, the live storages' bytes
    (``live``, ``peak``): a storage counts from the op that makes it (or
    :meth:`hold`) until it is freed."""

    def __init__(self, track_peak: bool):
        super().__init__()
        self.bytes = 0
        self.track_peak = track_peak
        self.live = 0
        self.peak = 0
        self._refs: dict[int, weakref.ref] = {}

    def hold(self, tensors) -> None:
        for t in tensors:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._refs:
                continue
            n = st.nbytes()
            self._refs[key] = weakref.ref(st, lambda _, key=key, n=n: self._free(key, n))
            self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key: int, n: int) -> None:
        self._refs.pop(key, None)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if moves_data(func):
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        if self.track_peak:
            self.hold(outs)
        return out


def _default_cache_logical(leaf: torch.Tensor) -> tuple:
    """The reference's fallback axes of a cache leaf for a family without
    ``cache_axes`` (hybrid, moe, encdec)."""
    nd = leaf.dim()
    if nd >= 4:
        return ("layers", "batch", "cache_seq", "kv_heads", "head_dim")[:nd]
    if nd == 2:
        return ("layers", "batch")
    return (None,) * nd


def _batch_spec(t: torch.Tensor, mesh) -> tuple:
    return shlib.resolve_spec(("batch",) + (None,) * (t.dim() - 1), tuple(t.shape), mesh)


def _per_device(pairs, mesh) -> int:
    """Bytes per device of (tensor, spec) pairs."""
    return sum(_nbytes(t) // shlib.spec_devices(spec, mesh) for t, spec in pairs)


def _pairs(abstract, specs) -> list:
    """(tensor, spec) for every leaf of ``abstract`` and the spec at its
    place in ``specs`` (a tree of ``abstract``'s structure)."""
    if abstract is None:
        return []
    if isinstance(abstract, torch.Tensor):
        return [(abstract, specs)]
    return [p for a, s in zip(abstract, specs) for p in _pairs(a, s)]


def _param_collectives(pairs, mesh, kind: str, remat: bool) -> dict:
    """The plan's collectives (see the module docstring), bytes per device."""
    out = {k: 0.0 for k in COLLECTIVE_OPS}
    count = 0
    data_n = mesh.shape["data"]
    pod_n = mesh.shape.get("pod", 1)
    gathers = (2 if remat else 1) if kind == "train" else 1
    for leaf, spec in pairs:
        named = {n for e in spec for n in (e if isinstance(e, tuple) else (e,)) if n}
        shard = _nbytes(leaf) / shlib.spec_devices(spec, mesh)
        if "data" in named and data_n > 1:
            full = shard * data_n      # the leaf gathered over data, per device
            out["all-gather"] += gathers * full
            count += gathers
            if kind == "train":
                out["reduce-scatter"] += full
                count += 1
        if kind == "train":
            for axis, n in (("data", data_n), ("pod", pod_n)):
                if n > 1 and axis not in named:
                    out["all-reduce"] += shard
                    count += 1
    out["count"] = float(count)
    out["total"] = sum(out[k] for k in COLLECTIVE_OPS)
    out["source"] = "plan"
    out["not_counted"] = NOT_COUNTED
    return out


def plan_step(cfg: ModelConfig, shape: ShapeConfig, mesh: AbstractMesh) -> dict:
    """Run one step of ``cfg`` at ``shape`` on fake tensors with ``mesh``
    ambient; returns the whole step's counts (not yet per device)."""
    long_ctx = shape.name == "long_500k"
    params_abs = api.abstract_params(cfg)
    params_spec = shlib.tree_shardings(params_abs, api.param_axes(cfg), mesh)
    param_pairs = _pairs(params_abs, params_spec)
    inputs_abs = api.input_specs(cfg, shape)
    inputs_spec = shlib.batch_shardings(inputs_abs, mesh)
    arg_pairs = param_pairs + [(inputs_abs[k], inputs_spec[k]) for k in inputs_abs]
    cache_abs, cache_pairs = None, []
    if shape.kind == "decode":
        cache_abs = api.abstract_cache(cfg, shape.global_batch, shape.seq_len, long_ctx)
        mod = api.module(cfg)
        if hasattr(mod, "cache_axes"):
            cache_spec = shlib.tree_shardings(cache_abs, mod.cache_axes(cfg), mesh)
        else:
            cache_spec = L.map_leaves(
                lambda t: shlib.resolve_spec(_default_cache_logical(t), tuple(t.shape), mesh),
                cache_abs)
        cache_pairs = _pairs(cache_abs, cache_spec)
        arg_pairs = param_pairs + cache_pairs + [(inputs_abs["tokens"], inputs_spec["tokens"])]

    track_peak = mesh.size == 1
    traffic = Traffic(track_peak)
    t0 = time.perf_counter()
    with FakeTensorMode():
        def fake(t):
            return torch.empty(t.shape, dtype=t.dtype)

        params = L.map_leaves(fake, params_abs)
        batch = {k: fake(v) for k, v in inputs_abs.items()}
        cache = None if cache_abs is None else L.map_leaves(fake, cache_abs)
        with FlopCounterMode(display=False) as flop_counter, traffic, \
                shlib.use_mesh(mesh) as scope:
            if track_peak:
                traffic.hold(L.leaves(params) + L.leaves(cache) + list(batch.values()))
            if shape.kind == "train":
                new_params, loss = api.make_train_step(cfg)(params, batch)
                outputs = L.leaves(new_params) + [loss]
            elif shape.kind == "prefill":
                outputs = [api.make_prefill_step(cfg)(params, batch)]
            else:
                new_cache, logits = api.make_serve_step(cfg, long_context=long_ctx)(
                    params, cache, batch["tokens"])
                outputs = L.leaves(new_cache) + [logits]
        out_abs = [torch.empty(t.shape, dtype=t.dtype, device="meta") for t in outputs]
    seconds = time.perf_counter() - t0

    # Outputs: new params take the params' specs, a decode's cache the
    # cache's; the rest (the loss, the last hidden state, the logits) the
    # batch rule.
    own = [spec for _, spec in (param_pairs if shape.kind == "train" else cache_pairs)]
    own += [_batch_spec(t, mesh) if t.dim() else () for t in out_abs[len(own):]]
    out_pairs = list(zip(out_abs, own))
    return dict(
        seconds=seconds, flops=float(flop_counter.get_total_flops()),
        bytes_accessed=float(traffic.bytes), peak_bytes=traffic.peak if track_peak else None,
        argument_bytes=_per_device(arg_pairs, mesh), output_bytes=_per_device(out_pairs, mesh),
        collectives=_param_collectives(param_pairs, mesh, shape.kind, cfg.remat),
        param_bytes=sum(_nbytes(t) for t in L.leaves(params_abs)),
        shard_hints=scope.hints,
    )


def dryrun_one(arch: str, shape_name: str, multi_pod: bool = False, *,
               cfg: ModelConfig | None = None, shape: ShapeConfig | None = None,
               mesh: AbstractMesh | None = None) -> dict:
    """The dry-run record of ``arch`` at ``shape_name`` on the production
    mesh (2 x 16 x 16 with ``multi_pod``).  ``cfg``, ``shape`` and
    ``mesh`` replace the published config, the named shape and the mesh
    (a cut config, a card cell's own shape, a one-device plan)."""
    cfg = configs.get(arch) if cfg is None else cfg
    shape = SHAPES[shape_name] if shape is None else shape
    ok, reason = api.supports_shape(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped", "reason": reason}
    mesh = make_production_mesh(multi_pod=multi_pod) if mesh is None else mesh
    chips = mesh.size
    plan = plan_step(cfg, shape, mesh)
    flops = plan["flops"] / chips
    nbytes = plan["bytes_accessed"] / chips
    coll = plan["collectives"]
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": list(mesh.shape.values()),
        "axes": list(mesh.axis_names),
        "chips": chips,
        "status": "ok",
        "kind": shape.kind,
        "global_batch": shape.global_batch,
        "seq_len": shape.seq_len,
        "layers": cfg.n_layers,
        "dtype": str(cfg.dtype).removeprefix("torch."),
        "compile_s": round(plan["seconds"], 1),
        "flops": flops,
        "bytes_accessed": nbytes,
        "collectives": coll,
        "corrected": {"flops": flops, "bytes_accessed": nbytes,
                      "collective_total": coll["total"]},
        "memory": {
            "argument_bytes": plan["argument_bytes"],
            "output_bytes": plan["output_bytes"],
            "temp_bytes": None,
            "peak_bytes": plan["peak_bytes"],
        },
        "param_bytes": plan["param_bytes"],
        "shard_hints": plan["shard_hints"],
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "model_flops": roofline.flops_of(cfg.active_param_count(), shape),
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = configs.model_archs() if (args.all or not args.arch) else [
        configs.canonical(args.arch)]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    n_fail = 0
    tag = "multipod" if args.multi_pod else "pod"
    for a in archs:
        for s in shapes:
            try:
                res = dryrun_one(a, s, multi_pod=args.multi_pod)
            except Exception as e:   # one record per pair, the failure kept in it
                res = {"arch": a, "shape": s, "status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
                n_fail += 1
            with open(os.path.join(args.out, f"{a}__{s}__{tag}.json"), "w") as f:
                json.dump(res, f, indent=1)
            status = res["status"]
            if status == "ok":
                extra = (f"flops={res['flops']:.3e} coll={res['collectives']['total']:.3e}B "
                         f"compile={res['compile_s']}s")
            elif status == "error":
                extra = res["error"][:160]
            else:
                extra = res.get("reason", "")[:80]
            print(f"[{status:7s}] {a:18s} x {s:12s} {extra}", flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} dry-run failures")


if __name__ == "__main__":
    main()

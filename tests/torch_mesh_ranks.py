"""Ranks of a ``torch.distributed`` client mesh for the mesh tests.

:func:`run_ranks` spawns W processes (``spawn`` start method) that meet
through a ``file://`` rendezvous in a work directory, so no TCP port is
chosen and parallel test workers cannot collide.  The parent writes the
jobs and their inputs to ``inputs.pt`` there; every rank runs every job
(:func:`run_job`) on the same inputs, each with its rank's view of the
mesh, and writes what it got to ``rank<r>.pt``.  A rank that raises, or a
run that outlives its timeout, fails the call.  This module imports no
JAX, so the ranks start with PyTorch alone (``tests/test_torch_mesh.py``
on the CPU over gloo, ``tests/test_torch_cuda.py`` on the card).

Jobs (tuples, first item the kind):

* ``("train", family, cfg, ds, inputs)``: ``hfl.train`` (family
  ``"hfl"``) or ``flat_fl.train_flat`` (``"flat"``) of one trial
  (``experiment.TrialInputs``) with the client mesh; gives the final flat
  params, the metrics, the kernels' launches and the clients of each
  launch (``clients``: kernel name -> list);
* ``("engine", mode, method, cfg, seeds, n_deployments, ds)``:
  ``Engine(shard_clients=True)`` (mode ``"clients"``) or
  ``Engine(shard_trials=True)`` (``"trials"``) ``.run``; gives the
  metrics and the log entry;
* ``("sweep", method, cfgs, seeds, n_deployments, ds)``:
  ``Engine(shard_trials=True).sweep``; gives the (C, S, P) metrics and
  the log entries;
* ``("hier",)``: ``aggregation.hierarchical_mean`` of rank r's update
  ``x_r`` (:func:`rank_update`) weighted by r + 1, two-level over pairs
  of ranks (intra ``{2i, 2i+1}``, inter ``{j, j+2}``) at W = 4, flat
  over the whole mesh at any W;
* ``("ring", w)``: ``aggregation.ring_mix`` of ``x_r`` with weight w;
* ``("pod", cfg, params, batch, kw, steps)``: ``steps`` steps of
  ``mesh_fl.make_pod_hfl_train_step(cfg, mesh, **kw)`` (rank r is pod r)
  from ``params`` and zero error buffers; gives the flat params, this
  rank's flat error buffers and the losses;
* ``("pod_data", cfg, params, batch, kw, steps, n_data)``: the same over
  ``sharding.pod_data_mesh(n_data)`` (W / ``n_data`` pods of ``n_data``
  data ranks);
* ``("step", cfg, params, batch, steps)``: ``models/api.make_train_step(
  cfg, data=mesh)`` on this rank's rows of ``batch`` (``mesh.rows``),
  ``steps`` steps, after ``optim/sgd.grad_and_value(loss_fn(cfg, mesh),
  mesh)`` on them; gives the new param leaves, the losses and the reduced
  gradient leaves (f32);
* ``("launch", argv)``: ``launch/train.main(argv)`` under the group, with
  ``CheckpointStore.save`` counted; gives its summary and this rank's
  saves (or the ``ValueError``'s message);
* ``("layout", n_data)``: this rank's place in ``sharding.pod_data_mesh(
  n_data)`` and its rank summed over each axis.
"""
from __future__ import annotations

import os
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import aggregation as agg
from repro_torch.core import flat_fl, hfl, mesh_fl
from repro_torch.engine import Engine
from repro_torch.kernels import fused_agg, local_train
from repro_torch.launch import sharding
from repro_torch.launch import train as lm_train
from repro_torch.models import api
from repro_torch.models import autoencoder as ae
from repro_torch.optim import sgd


def rank_update(rank: int) -> torch.Tensor:
    """Rank r's update for the collective jobs: a (2, 3) tensor."""
    return torch.arange(6, dtype=torch.float32).reshape(2, 3) * (rank + 1) - 0.5 * rank


def _launches() -> dict[str, int]:
    return {**local_train.LAUNCHES, **fused_agg.LAUNCHES}


def _metrics(m) -> dict[str, torch.Tensor]:
    return {k: v.cpu() for k, v in m._asdict().items()}


def _record_clients() -> dict[str, list[int]]:
    """Wrap the two launch wrappers of an unchunked round so that each call
    records its client count (the rows of its first argument); returns
    the record."""
    seen: dict[str, list[int]] = {"local_train_f32": [], "fused_agg": []}
    for mod, attr, kernel in ((local_train, "train_clients", "local_train_f32"),
                              (fused_agg, "compress_aggregate_blocks", "fused_agg")):
        def wrapped(x, *args, _launch=getattr(mod, attr), _seen=seen[kernel], **kw):
            _seen.append(int(x.shape[0]))
            return _launch(x, *args, **kw)
        setattr(mod, attr, wrapped)
    return seen


def run_job(job: tuple, mesh: sharding.ClientMesh, device: torch.device) -> dict:
    """One job on this rank (see the module docstring)."""
    kind = job[0]
    if kind == "train":
        _, family, cfg, ds, inputs = job
        fn = hfl.train if family == "hfl" else flat_fl.train_flat
        ds = type(ds)(*(t.to(device) for t in ds))
        local_train.reset_launches()
        fused_agg.reset_launches()
        for seen in CLIENTS.values():
            seen.clear()
        params, m = fn(inputs.params, ae.loss, ds, cfg, inputs.dep, inputs.draws,
                       client_mesh=mesh)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return {"params": ae.ravel(params).cpu(), "metrics": _metrics(m),
                "launches": _launches(),
                "clients": {k: list(v) for k, v in CLIENTS.items()}}
    if kind == "engine":
        _, mode, method, cfg, seeds, n_dep, ds = job
        eng = Engine(shard_clients=mode == "clients", shard_trials=mode == "trials",
                     device=device)
        run = eng.run(method, cfg, seeds, ds, n_deployments=n_dep)
        return {"metrics": {k: v.cpu() for k, v in run.metrics.items()}, "log": eng.take_log()}
    if kind == "sweep":
        _, method, cfgs, seeds, n_dep, ds = job
        eng = Engine(shard_trials=True, device=device)
        sw = eng.sweep(method, cfgs, seeds, ds, n_deployments=n_dep)
        return {"metrics": {k: v.cpu() for k, v in sw.metrics.items()}, "log": eng.take_log()}
    if kind in ("pod", "pod_data"):
        _, cfg, params, batch, kw, steps = job[:6]
        params = sgd.tree_unflatten(params, [p.to(device) for p in sgd.tree_leaves(params)])
        pods = mesh if kind == "pod" else sharding.pod_data_mesh(job[6])
        step = mesh_fl.make_pod_hfl_train_step(cfg, pods, **kw)
        err, losses = mesh_fl.init_err(params), []
        for _ in range(steps):
            params, err, loss = step(params, err, {k: v.to(device) for k, v in batch.items()})
            losses.append(loss)
        return {"params": sgd.ravel_tree(params).cpu(), "err": sgd.ravel_tree(err).cpu(),
                "losses": torch.stack(losses).cpu()}
    if kind == "step":
        _, cfg, params, batch = job[:4]
        params = sgd.tree_unflatten(params, [p.to(device) for p in sgd.tree_leaves(params)])
        rows = mesh.rows(batch["tokens"].shape[0])
        mine = {k: v[rows].to(device) for k, v in batch.items()}
        step = api.make_train_step(cfg, mesh)
        grads, _ = sgd.grad_and_value(api.loss_fn(cfg, mesh), mesh)(params, mine)
        losses = []
        for _ in range(job[4]):
            params, loss = step(params, mine)
            losses.append(loss)
        return {"params": [p.cpu() for p in sgd.tree_leaves(params)],
                "grads": [g.cpu() for g in sgd.tree_leaves(grads)],
                "losses": torch.stack(losses).cpu()}
    if kind == "launch":
        saves, plain = [], lm_train.CheckpointStore.save

        def counted(self, step, params, _plain=plain):
            saves.append(step)
            return _plain(self, step, params)
        lm_train.CheckpointStore.save = counted
        try:
            return {"out": lm_train.main(job[1]), "saves": saves}
        except ValueError as e:
            return {"raised": str(e)}
        finally:
            lm_train.CheckpointStore.save = plain
    if kind == "layout":
        pdm = sharding.pod_data_mesh(job[1])
        x = torch.tensor([float(mesh.rank)], device=device)
        return {"pod": (pdm.pod.rank, pdm.pod.size), "data": (pdm.data.rank, pdm.data.size),
                "shape": pdm.shape, "pod_sum": float(pdm.pod.sum_(x.clone())),
                "data_sum": float(pdm.data.sum_(x.clone())),
                "data_mean": pdm.data.mean_(x.to(torch.bfloat16)).cpu()}
    x = rank_update(mesh.rank).to(device)
    if kind == "hier":
        w = torch.tensor(float(mesh.rank + 1), device=device)
        out = {"flat": agg.hierarchical_mean(x, w, intra_axis=mesh).cpu()}
        if mesh.size == 4:
            # Every rank makes every group, in the same order.
            pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
            columns = [dist.new_group([0, 2]), dist.new_group([1, 3])]
            intra = sharding.client_mesh(pairs[mesh.rank // 2])
            inter = sharding.client_mesh(columns[mesh.rank % 2])
            out["two_level"] = agg.hierarchical_mean(
                {"x": [x]}, w, intra_axis=intra, inter_axis=inter)["x"][0].cpu()
        return out
    if kind == "ring":
        return {"mixed": agg.ring_mix(x, job[1], mesh).cpu()}
    raise ValueError(f"unknown job {kind!r}")


CLIENTS: dict[str, list[int]] = {}   # this rank's launches' client counts, per kernel


def _rank(rank: int, world: int, backend: str, workdir: str) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    CLIENTS.update(_record_clients())
    torch.set_num_threads(1)
    work = Path(workdir)
    spec = torch.load(work / "inputs.pt", weights_only=False)
    device = torch.device(spec["device"])
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{work / 'rendezvous'}",
                            world_size=world, rank=rank)
    try:
        mesh = sharding.client_mesh()
        torch.save([run_job(job, mesh, device) for job in spec["jobs"]],
                   work / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_ranks(jobs: list, world: int, workdir: Path, *, device: str = "cpu",
              backend: str = "gloo", timeout_s: float = 120.0) -> list[list[dict]]:
    """Run ``jobs`` on ``world`` spawned ranks meeting in ``workdir`` (a
    fresh directory): each rank's results, job by job."""
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save({"device": device, "jobs": jobs}, workdir / "inputs.pt")
    ctx = mp.start_processes(_rank, args=(world, backend, str(workdir)), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks did not finish in {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(world)]

"""Training launcher, the port of ``repro.launch.train``.

Two entry modes:

  federated  — the paper's pipeline: hierarchical (or flat) federated
               anomaly-detector training over the simulated underwater
               acoustic network (``launch/experiment.run_method`` over the
               synthetic fleet of ``data/synthetic``).

      PYTHONPATH=src python -m repro_torch.launch.train federated \\
          --method hfl-selective --sensors 100 --fog 10 --rounds 20

  production — plain-SGD training of an assigned language model
               (``models/api.make_train_step``) on random token batches
               (and an enc-dec model's random frame embeddings) drawn on
               the device; REDUCED config unless ``--full``; with
               ``--ckpt-dir`` it resumes from the latest checkpoint there
               and saves every ``--ckpt-every`` steps and at the end.

      PYTHONPATH=src python -m repro_torch.launch.train production \\
          --arch llama3-8b --steps 20 --batch 8 --seq 128

               Data-parallel over every card of a node, one rank a card
               (the reference's ``data`` mesh axis):

      PYTHONPATH=src torchrun --nproc-per-node <cards> \\
          -m repro_torch.launch.train production --arch llama3-8b --batch 8

               Under ``torchrun`` the production mode sets each rank's card
               from ``LOCAL_RANK`` and joins an NCCL group (gloo with
               ``--device cpu``).  Under any initialised process group of W
               ranks every rank draws the same global batch from the same
               seed and trains on its W-th of the rows; the gradients are
               mean-reduced over the ranks (``models/api.make_train_step``
               with ``data``), every rank restores a checkpoint, and rank 0
               alone saves and prints.  W must divide ``--batch``.

Both run on the card unless ``--device cpu`` (or ``device="cpu"``) is
given.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch import device as _device
from repro_torch.checkpoint import CheckpointStore
from repro_torch.data.synthetic import SyntheticConfig, generate, normalize
from repro_torch.launch import experiment as exp
from repro_torch.launch import sharding
from repro_torch.models import api
from repro_torch.models import layers as L


def run_federated(args: argparse.Namespace, dev: torch.device) -> dict:
    cfg = exp.make_config(
        n_sensors=args.sensors,
        n_fog=args.fog,
        rounds=args.rounds,
        local_epochs=args.local_epochs,
        lr=args.lr,
    )
    ds = normalize(generate(
        torch.Generator().manual_seed(args.seed),
        SyntheticConfig(n_sensors=args.sensors, dirichlet_alpha=args.dirichlet_alpha),
        device=dev,
    ))
    t0 = time.time()
    res = exp.run_method(args.method, ds, cfg, seed=args.seed, device=dev)
    wall = time.time() - t0
    return {
        "mode": "federated",
        "method": res.method,
        "f1": res.f1,
        "participation": res.participation,
        "energy_j": {
            "total": res.e_total,
            "s2f": res.e_s2f,
            "f2f": res.e_f2f,
            "f2g": res.e_f2g,
        },
        "final_loss": res.losses[-1] if res.losses else None,
        "wall_s": round(wall, 1),
    }


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def data_mesh() -> sharding.ClientMesh | None:
    """The data mesh of production training: every rank of the default
    process group when one of several ranks is initialised, else None."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    mesh = sharding.client_mesh()
    return mesh if mesh.size > 1 else None


def run_production(args: argparse.Namespace, dev: torch.device) -> dict:
    cfg = configs.get(args.arch, reduced=not args.full)
    data = data_mesh()
    world, rank = (1, 0) if data is None else (data.size, data.rank)
    if args.batch % world:
        raise ValueError(f"a batch of {args.batch} rows does not split over {world} data ranks")
    mine = slice(rank * (args.batch // world), (rank + 1) * (args.batch // world))
    g = torch.Generator(device=dev).manual_seed(args.seed)
    params = api.init_params(g, cfg)
    param_bytes = sum(t.numel() * t.element_size() for t in L.leaves(params))
    step = api.make_train_step(cfg, data)

    store = CheckpointStore(args.ckpt_dir) if args.ckpt_dir else None
    saves = store is not None and rank == 0
    start = 0
    if store is not None and store.latest_step() is not None:
        params, start = store.restore(params)
        if rank == 0:
            print(f"restored checkpoint at step {start}")

    losses, step_s = [], []
    t0 = time.time()
    for i in range(start, start + args.steps):
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (args.batch, args.seq), generator=g,
                                         device=dev, dtype=torch.int32)}
        if cfg.family == "encdec":
            batch["audio_embeds"] = torch.randn(
                (args.batch, cfg.n_audio_frames, cfg.d_model), generator=g, device=dev,
            ).to(cfg.dtype)
        if cfg.n_visual_tokens > 0:
            batch["visual_embeds"] = torch.randn(
                (args.batch, cfg.n_visual_tokens, cfg.d_model), generator=g, device=dev,
            ).to(cfg.dtype)
        if data is not None:    # every rank drew the global batch; this rank's rows
            batch = {k: v[mine] for k, v in batch.items()}
        _sync(dev)
        ts = time.perf_counter()
        params, loss = step(params, batch)
        losses.append(float(loss))        # reads the loss back: the step has ended
        step_s.append(time.perf_counter() - ts)
        if saves and (i + 1) % args.ckpt_every == 0:
            store.save(i + 1, params)
    wall = time.time() - t0
    if saves:
        store.save(start + args.steps, params)
    if data is not None:    # every rank returns after rank 0's last save
        dist.barrier(data.group)
    later = step_s[1:] or step_s
    return {
        "mode": "production",
        "arch": args.arch,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "start": start,
        "steps": args.steps,
        "data_ranks": world,
        "rank": rank,
        "loss_first": losses[0],
        "loss_last": losses[-1],
        "losses": losses,
        "step_s": step_s,
        "tokens_per_s": args.batch * args.seq * len(later) / sum(later),
        "param_bytes": param_bytes,
        "wall_s": round(wall, 1),
        "finite": all(math.isfinite(x) for x in losses),
    }


def main(argv: list[str] | None = None, device: torch.device | str | None = None) -> dict:
    """Run the launcher; ``argv`` defaults to ``sys.argv[1:]``.
    ``device=None`` (and no ``--device``) means the card.  Prints and
    returns the summary (``production`` adds each step's seconds, the
    tokens/s of the steps after the first and the params' bytes).

    ``production`` is data-parallel under an initialised process group
    (the caller's), or under ``torchrun`` (``WORLD_SIZE`` > 1 in the
    environment), where it sets the card from ``LOCAL_RANK``, joins an
    NCCL group (gloo for ``--device cpu``) and leaves it at the end.  Two
    ranks cannot share a card over NCCL: a caller that puts them on one
    card initialises a gloo group itself.  Only rank 0 prints."""
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="mode", required=True)

    fed = sub.add_parser("federated")
    fed.add_argument("--method", default="hfl-selective", choices=exp.METHODS)
    fed.add_argument("--sensors", type=int, default=100)
    fed.add_argument("--fog", type=int, default=10)
    fed.add_argument("--rounds", type=int, default=20)
    fed.add_argument("--local-epochs", type=int, default=5)
    fed.add_argument("--lr", type=float, default=0.01)
    fed.add_argument("--dirichlet-alpha", type=float, default=1.0)
    fed.add_argument("--seed", type=int, default=0)

    prod = sub.add_parser("production")
    prod.add_argument("--arch", required=True)
    prod.add_argument("--steps", type=int, default=10)
    prod.add_argument("--batch", type=int, default=4)
    prod.add_argument("--seq", type=int, default=64)
    prod.add_argument("--full", action="store_true",
                      help="the published config (needs the card's memory)")
    prod.add_argument("--ckpt-dir", default=None)
    prod.add_argument("--ckpt-every", type=int, default=100)
    prod.add_argument("--seed", type=int, default=0)

    for p in (fed, prod):
        p.add_argument("--device", default=None, help="cpu, or a CUDA device (default cuda:0)")
    args = ap.parse_args(argv)
    device = device if device is not None else args.device
    joined = (args.mode == "production" and not dist.is_initialized()
              and int(os.environ.get("WORLD_SIZE", "1")) > 1)
    if joined:          # torchrun: one rank a card, the card set before any tensor is made
        if device is None:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group("gloo" if str(device) == "cpu" else "nccl")
    try:
        dev = _device.resolve(device)
        if args.mode == "federated":
            out = run_federated(args, dev)
        else:
            out = run_production(args, dev)
    finally:
        if joined:
            dist.destroy_process_group()
    if out.get("rank", 0) == 0:
        print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()

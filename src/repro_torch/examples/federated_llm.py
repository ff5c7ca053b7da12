"""The paper's technique at language-model scale: hierarchical federated
fine-tuning of a llama3 (REDUCED by default), the port of the reference's
``examples/federated_llm.py``.

Clients and pods map onto two ``launch/sharding.ClientMesh`` axes, and
the paper's three components onto their collectives:

  sensor->fog upload        -> weighted mean within ``intra`` (all_reduce)
  fog->gateway uplink       -> weighted mean across ``inter``
  Top-K+EF+int8 compression -> each client's update compressed BEFORE the
                               expensive cross-pod hop (``compress_q8`` on
                               the card: the whole model is one f32 row)
  selective fog cooperation -> ring gossip over ``inter``

Run alone, both axes are one process: a one-rank process group (gloo on
the CPU, NCCL on the card) is set up for the run and taken down after it,
and every collective is the identity.

  PYTHONPATH=src python -m repro_torch.examples.federated_llm [--device cpu] [--steps 5]
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch import device as _device
from repro_torch.core import aggregation as agg
from repro_torch.core import compression as comp
from repro_torch.data.pipeline import lm_batches
from repro_torch.launch import sharding
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.optim import sgd

CLIENT_LR = 1e-3          # the client's step: delta = -CLIENT_LR * grad
MIX_WEIGHT = 0.2          # ring gossip weight over the pods


def fed_step(cfg, params, err: torch.Tensor, batch: dict, compressor, intra, inter):
    """One client's local step and compressed update, the two-level mean
    and the ring mix: (new params, new error buffer (1, d), loss)."""
    grads, loss = sgd.grad_and_value(api.loss_fn(cfg))(params, batch)
    delta = -CLIENT_LR * sgd.ravel_tree(
        [g.to(torch.float32) for g in sgd.tree_leaves(grads)])
    del grads
    recon, new_err = comp.compress_update(delta[None], err, compressor)
    one = torch.ones((), dtype=torch.float32, device=delta.device)
    update = agg.hierarchical_mean(recon[0], one, intra_axis=intra, inter_axis=inter)
    update = agg.ring_mix(update, MIX_WEIGHT, axis=inter)
    pieces = sgd.unravel_tree(update, sgd.tree_leaves(params))
    new = [api.sgd_update(p, u, 1.0) for p, u in zip(sgd.tree_leaves(params), pieces)]
    loss = intra.sum_(loss.reshape(1).clone())[0] / intra.size
    return sgd.tree_unflatten(params, new), new_err, loss


def run(cfg, steps: int, dev: torch.device, intra, inter) -> dict:
    """``steps`` federated steps of ``cfg`` on ``dev`` over the two
    meshes; params and tokens from CPU generators (seeds 0, 1 and 2),
    moved, so every device sees the same ones.  Prints the payload and the
    losses; returns them with the final params."""
    params = L.map_leaves(lambda t: t.to(dev),
                          api.init_params(torch.Generator().manual_seed(0), cfg))
    compressor = comp.CompressorConfig(rho_s=0.05, quant_bits=8, mode="blockwise")
    stream = torch.randint(0, cfg.vocab_size, (4096,), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    d = sum(p.numel() for p in sgd.tree_leaves(params))
    err = torch.zeros((1, d), dtype=torch.float32, device=dev)
    bits = comp.payload_bits(d, compressor)
    print(f"model: {cfg.name} ({d:,} params)")
    print(f"compressed cross-pod payload: {bits / 8 / 1024:.1f} KiB "
          f"(vs {32 * d / 8 / 1024:.1f} KiB dense, "
          f"{comp.compression_ratio(d, compressor):.1%})")
    g, losses = torch.Generator().manual_seed(2), []
    for step in range(steps):
        batch = {"tokens": lm_batches(g, stream, 2, 32).to(dev)}
        params, err, loss = fed_step(cfg, params, err, batch, compressor, intra, inter)
        losses.append(float(loss))
        print(f"step {step}: loss {losses[-1]:.4f}")
    return {"d": d, "payload_bits": bits, "losses": losses, "params": params}


def main(argv: list[str] | None = None, *, cfg: Any = None, steps: int | None = None,
         device: torch.device | str | None = None, intra: Any = None,
         inter: Any = None) -> dict:
    """Run the example; ``argv`` defaults to ``sys.argv[1:]``.  ``cfg``
    (default llama3-8b REDUCED), ``steps`` and ``device`` override the
    flags; ``device=None`` and no ``--device`` mean the card.  ``intra``
    and ``inter`` are the client and pod meshes; without them the run is
    one process, in a one-rank process group set up here (unless one
    exists) and taken down after the run.  Returns :func:`run`'s result."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default cuda:0)")
    args = ap.parse_args(argv)
    dev = _device.resolve(device if device is not None else args.device)
    cfg = configs.get("llama3-8b", reduced=True) if cfg is None else cfg
    steps = args.steps if steps is None else steps
    if intra is not None or inter is not None:
        return run(cfg, steps, dev, intra, inter)
    workdir = None
    if not dist.is_initialized():
        workdir = tempfile.mkdtemp(prefix="federated_llm_")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{os.path.join(workdir, 'rdv')}",
                                rank=0, world_size=1)
    mesh = sharding.client_mesh()
    if mesh.size != 1:
        raise ValueError("under a process group of several ranks pass intra and inter")
    out = run(cfg, steps, dev, mesh, mesh)
    if workdir is not None:
        dist.destroy_process_group()
        shutil.rmtree(workdir, ignore_errors=True)
    return out


if __name__ == "__main__":
    main()

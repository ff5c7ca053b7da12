"""End-to-end train-and-serve: federated training publishes rounds into a
CheckpointStore while the online scoring service consumes them, the port
of the reference's ``examples/serve_anomaly.py``.

The paper's deployment shape (Sec. V-D) as one pipeline:

  1. a short ``hfl.train`` run publishes its first rounds into the store;
  2. a :class:`repro_torch.serving.ScoringService` comes up on the latest
     round, calibrates per-fog + global thresholds from a validation
     stream (streaming reservoirs, ``serving/calibrate``), and scores a
     first wave of telemetry with the fused score kernel;
  3. training CONTINUES (publishing with a round offset) and the service
     hot-swaps the fresh params mid-stream (double-buffered, same tree)
     before scoring the second wave.

Prints a JSON summary (swaps, compile count, throughput, detection F1)
and returns it.

  PYTHONPATH=src python -m repro_torch.examples.serve_anomaly [--rounds 6] [--device cpu]

Runs on the card unless ``--device cpu`` (or ``device="cpu"``) is given.
"""
from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.checkpoint import CheckpointStore
from repro_torch.core import anomaly, hfl
from repro_torch.core import topology as topo
from repro_torch.data.synthetic import SyntheticConfig, generate, normalize
from repro_torch.launch import experiment as exp
from repro_torch.models import autoencoder as ae
from repro_torch.serving import ScoringService, StreamingCalibrator

HIDDEN = (16, 8, 16)


def _train(seed: int, params, ds, cfg, store, publish_offset: int = 0):
    """``hfl.train`` from ``params`` on a deployment and round draws from
    ``torch.Generator().manual_seed(seed)``, publishing every round."""
    g = torch.Generator().manual_seed(seed)
    n, window, d = ds.train.shape
    dep = topo.sample_deployment(g, cfg.deployment, device="cpu")
    draws = hfl.draw_rounds(g, cfg, n, window, d=ae.param_count(d, HIDDEN))
    return hfl.train(params, ae.loss, ds, cfg, dep, draws, store=store,
                     publish_offset=publish_offset)


def main(argv: list[str] | None = None, device: torch.device | str | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--n-sensors", type=int, default=10)
    ap.add_argument("--n-fog", type=int, default=3)
    ap.add_argument("--train-len", type=int, default=64)
    ap.add_argument("--batch-rows", type=int, default=512)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default cuda:0)")
    args = ap.parse_args(argv)
    dev = _device.resolve(device if device is not None else args.device)

    dcfg = SyntheticConfig(
        n_sensors=args.n_sensors,
        train_len=args.train_len,
        val_len=max(24, args.train_len // 2),
        test_len=args.train_len,
    )
    ds = normalize(generate(torch.Generator().manual_seed(args.seed), dcfg, device=dev))
    d = ds.train.shape[-1]
    params0 = ae.init(torch.Generator().manual_seed(args.seed + 1), d, HIDDEN, device="cpu")
    cfg = exp.make_config(n_sensors=args.n_sensors, n_fog=args.n_fog, rounds=args.rounds,
                          local_epochs=1)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="serve_anomaly_")
    store = CheckpointStore(ckpt_dir, keep=3)

    # --- phase 1: first half of training, publishing every round ---------
    half = max(1, args.rounds // 2)
    params, _ = _train(args.seed + 2, params0, ds, cfg.replace(rounds=half), store)
    print(f"phase 1: published rounds {store.steps()} -> {ckpt_dir}")

    # --- serve: calibrate from the validation stream, score wave A -------
    calib = StreamingCalibrator(capacity=2048, n_fog=args.n_fog)
    svc = ScoringService(store, params0, batch_rows=args.batch_rows, calibrator=calib,
                         device=dev)
    fog_id = np.arange(args.n_sensors) % args.n_fog     # serving-side routing
    val = ds.val.cpu().numpy()
    test = ds.test.cpu().numpy()
    svc.ingest_validation(val, fog_id[:, None])
    print(f"serving round {svc.loaded_step}; global tau = {float(calib.global_tau):.3f}")

    wave_a = {s: svc.submit(test[s], fog=int(fog_id[s])) for s in range(args.n_sensors)}
    res_a = svc.drain()

    # --- phase 2: training continues; the service hot-swaps mid-stream ---
    _train(args.seed + 3, params, ds, cfg.replace(rounds=args.rounds - half), store,
           publish_offset=half)
    swapped = svc.poll()
    svc.ingest_validation(val, fog_id[:, None])
    print(f"phase 2: published rounds {store.steps()}, "
          f"hot-swapped to round {svc.loaded_step} (swapped={swapped})")

    wave_b = {s: svc.submit(test[s], fog=int(fog_id[s])) for s in range(args.n_sensors)}
    res_b = svc.drain()

    # --- detection quality of the served model (wave B flags) ------------
    flags = torch.as_tensor(np.stack([np.asarray(res_b[wave_b[s]].flag)
                                      for s in range(args.n_sensors)]))
    f1 = anomaly.pointwise_f1(flags.reshape(-1), ds.test_label.cpu().reshape(-1))
    moved = float(np.mean(np.abs(
        np.stack([res_b[wave_b[s]].error for s in range(args.n_sensors)])
        - np.stack([res_a[wave_a[s]].error for s in range(args.n_sensors)])
    )))

    summary = {
        "rounds_published": store.steps(),
        "served_round": svc.loaded_step,
        "swapped": bool(swapped),
        "mean_abs_error_shift": moved,    # params really changed mid-stream
        "f1": float(f1.f1),
        "precision": float(f1.precision),
        "recall": float(f1.recall),
        "service": svc.stats.summary(),
    }
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()

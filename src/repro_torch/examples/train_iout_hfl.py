"""End-to-end driver: federated training of the underwater anomaly
detector with checkpointing, per-round metric logs and a final evaluation
on the SMD benchmark, the port of the reference's
``examples/train_iout_hfl.py``.

The paper's pipeline end to end:
  deployment -> feasibility graph -> nearest-feasible-fog association ->
  E local epochs -> Top-K+EF+int8 compressed uplinks -> fog aggregation ->
  selective fog mixing -> surface aggregation -> threshold calibration ->
  PA-F1 evaluation.

SMD's files are read from ``data/`` when present; otherwise the loader's
surrogate (10 entities x 38 features) stands in.  Checkpoints go to
``--ckpt-dir``, a new temporary directory by default.

  PYTHONPATH=src python -m repro_torch.examples.train_iout_hfl [--rounds 10] [--device cpu]

Runs on the card unless ``--device cpu`` (or ``device="cpu"``) is given.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch import device as _device
from repro_torch.checkpoint import CheckpointStore
from repro_torch.core import anomaly, hfl
from repro_torch.core.cooperation import CoopRule
from repro_torch.data import benchmarks as bench
from repro_torch.launch import experiment as exp
from repro_torch.models import autoencoder as ae


def main(argv: list[str] | None = None, device: torch.device | str | None = None) -> dict:
    """Train, checkpoint and evaluate; returns the per-round metrics, the
    PA-F1 and the checkpoint directory's listing."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--local-epochs", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default cuda:0)")
    args = ap.parse_args(argv)
    dev = _device.resolve(device if device is not None else args.device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="iout_hfl_ckpt_")

    bd = bench.load("smd", seed=args.seed, length=128, device=dev)
    ds = bd.dataset
    n = ds.train.shape[0]
    print(f"dataset: SMD ({bd.source}), {n} entities, D={ds.train.shape[-1]}")

    cfg = exp.make_config(n_sensors=n, n_fog=3, rounds=args.rounds,
                          local_epochs=args.local_epochs, rule=CoopRule.SELECTIVE)
    inputs = exp.draw_trial(torch.Generator().manual_seed(args.seed), ds, cfg)
    state, draws = hfl.start(inputs.params, ds, cfg, inputs.dep, inputs.draws)
    round_fn = hfl.make_round_fn(ae.loss, ds, cfg)
    store = CheckpointStore(ckpt_dir, keep=2)

    print(f"{'round':>5} {'loss':>9} {'part':>5} {'E (J)':>8} {'coop':>4} {'batt':>7}")
    rounds = []
    for t in range(args.rounds):
        state, m = round_fn(state, *draws.round(t))
        row = dict(loss=float(m.loss), participation=float(m.participation),
                   e_total=float(m.e_total), coop_links=int(m.coop_links),
                   battery_min=float(m.battery_min))
        rounds.append(row)
        print(f"{t:>5} {row['loss']:>9.4f} {row['participation']:>5.2f} "
              f"{row['e_total']:>8.4f} {row['coop_links']:>4} {row['battery_min']:>7.2f}")
        store.save(t + 1, state.params)

    # Threshold calibration + PA-F1 (paper Sec. V-D / VI-F protocol).
    d = ds.val.shape[-1]
    r = anomaly.evaluate_detector(ae.apply, state.params, ds.val.reshape(-1, d),
                                  ds.test.reshape(-1, d), ds.test_label.reshape(-1),
                                  point_adjusted=True)
    print(f"\nPA-F1 {float(r.f1):.4f}  (P {float(r.precision):.4f} / "
          f"R {float(r.recall):.4f})")
    checkpoints = sorted(os.listdir(ckpt_dir))
    print(f"checkpoints: {checkpoints}")
    return {"source": bd.source, "entities": n, "rounds": rounds, "f1": float(r.f1),
            "precision": float(r.precision), "recall": float(r.recall),
            "ckpt_dir": ckpt_dir, "checkpoints": checkpoints}


if __name__ == "__main__":
    main()

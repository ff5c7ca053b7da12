"""Quickstart: train an underwater hierarchical-FL anomaly detector in ~1 min,
the port of the reference's ``examples/quickstart.py``.

Builds a 24-sensor / 5-fog synthetic IoUT deployment, trains the paper's
autoencoder with FedAvg and three hierarchical methods (compressed
uplinks), and prints detection quality, participation and the three-tier
energy breakdown.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Runs on the card unless ``--device cpu`` (or ``device="cpu"``) is given.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import device as _device
from repro_torch.data.synthetic import SyntheticConfig, generate, normalize
from repro_torch.launch import experiment as exp

METHODS = ("fedavg", "hfl-nocoop", "hfl-selective", "hfl-nearest")


def main(argv: list[str] | None = None, device: torch.device | str | None = None) -> dict:
    """Run the four methods; returns {method: ``ExperimentResult``}."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default cuda:0)")
    args = ap.parse_args(argv)
    dev = _device.resolve(device if device is not None else args.device)
    n_sensors, n_fog = 24, 5

    ds = normalize(generate(
        torch.Generator().manual_seed(0),
        SyntheticConfig(n_sensors=n_sensors, train_len=96, val_len=32, test_len=96),
        device=dev,
    ))
    cfg = exp.make_config(n_sensors=n_sensors, n_fog=n_fog, rounds=6, local_epochs=2,
                          batch_size=16)

    print("method            F1     part   E_total  (s2f / f2f / f2g) J")
    results = {}
    for method in METHODS:
        r = exp.run_method(method, ds, cfg, seed=0, device=dev)
        results[method] = r
        print(
            f"{method:14} {r.f1:6.3f} {r.participation:6.2f} "
            f"{r.e_total:8.3f}  ({r.e_s2f:.3f} / {r.e_f2f:.3f} / {r.e_f2g:.3f})"
        )

    print(
        "\nExpected pattern (paper Sec. VI): flat FL is cheapest but only a"
        "\nsubset of sensors participates; hierarchy restores participation;"
        "\nselective cooperation costs less than always-on (f2f column)."
    )
    return results


if __name__ == "__main__":
    main()

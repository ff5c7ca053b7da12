"""Batched serving example: prefill + autoregressive decode with the
per-family cache (KV / SSM state / RG-LRU state) through the serving
launcher, the port of the reference's ``examples/serve_model.py``.

  PYTHONPATH=src python -m repro_torch.examples.serve_model [--arch mamba2-2.7b] [--device cpu]

Runs on the card unless ``--device cpu`` (or ``device="cpu"``) is given.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.launch import serve


def main(argv: list[str] | None = None, device: torch.device | str | None = None) -> dict:
    """Serve ``--arch`` (REDUCED) for a batch of 4: 16 prompt tokens, 8
    new; returns ``launch/serve.main``'s summary."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="mamba2-2.7b")
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default cuda:0)")
    args = ap.parse_args(argv)
    return serve.main(["--arch", args.arch, "--batch", "4", "--prompt-len", "16",
                       "--new-tokens", "8"], device=device if device is not None else args.device)


if __name__ == "__main__":
    main()

"""Replay a bursty arrival trace against the scoring service, two ways,
the port of the reference's ``examples/load_replay.py``.

The IoUT serving problem in one runnable file: telemetry surfaces in
bursts (on/off MMPP), and a fixed-size micro-batcher strands every
burst's leftover rows through the following silence.  This example
replays the SAME deterministic trace on a virtual clock against

  * the legacy fixed 1024-row batcher, and
  * deadline-driven adaptive micro-batching with 128/1024 shape buckets
    (optionally int8 serving weights via ``--int8``),

then prints a JSON comparison of true end-to-end request latency (queue
wait + batch formation + device time) and returns it.  Expect the
adaptive p99 to be ~max_wait_s while the fixed p99 rides the silence
lengths.

  PYTHONPATH=src python -m repro_torch.examples.load_replay [--duration 4] [--int8] [--device cpu]

Runs on the card unless ``--device cpu`` (or ``device="cpu"``) is given.
"""
from __future__ import annotations

import argparse
import json
import tempfile

import torch

from repro_torch import device as _device
from repro_torch.checkpoint import CheckpointStore
from repro_torch.loadgen import VirtualClock, mmpp_trace, replay
from repro_torch.models import autoencoder as ae
from repro_torch.serving import ScoringService

D = 32


def run_config(name, trace, params, store, dev, *, buckets, max_wait_s, weight_dtype="f32"):
    clock = VirtualClock()
    svc = ScoringService(store, params, buckets=buckets, max_wait_s=max_wait_s, tau=1.0,
                         weight_dtype=weight_dtype, clock=clock, device=dev)
    rep = replay(svc, trace, clock, d=D)
    s = rep.summary()
    print(
        f"{name:>18}: p50 {s['e2e_p50_ms']:8.1f} ms   "
        f"p99 {s['e2e_p99_ms']:8.1f} ms   mean fill {s['mean_fill']:6.1f}   "
        f"compiles {s['compiles_by_bucket']}"
    )
    return s


def main(argv: list[str] | None = None, device: torch.device | str | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--duration", type=float, default=4.0)
    ap.add_argument("--rate-on", type=float, default=2000.0,
                    help="burst arrival rate, events/s")
    ap.add_argument("--max-wait-ms", type=float, default=20.0)
    ap.add_argument("--int8", action="store_true",
                    help="also replay with int8-quantised serving weights")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default cuda:0)")
    args = ap.parse_args(argv)
    dev = _device.resolve(device if device is not None else args.device)

    trace = mmpp_trace(
        args.seed, rate_on_hz=args.rate_on, mean_on_s=0.3, mean_off_s=0.5,
        duration_s=args.duration, fleet=64, n_fog=4, rows=16,
    )
    print(f"trace: {trace.n_events} events / {trace.total_rows} rows, "
          f"{trace.meta['bursts']} bursts over {trace.duration_s}s")

    params = ae.init(torch.Generator().manual_seed(args.seed + 1), D, (16, 8, 16), device="cpu")
    wait = args.max_wait_ms / 1e3
    with tempfile.TemporaryDirectory(prefix="load_replay_") as tmp:
        store = CheckpointStore(tmp, keep=2)
        store.publish(1, params)
        out = {
            "trace": trace.summary(),
            "fixed": run_config("fixed", trace, params, store, dev, buckets=(1024,),
                                max_wait_s=None),
            "adaptive_bucketed": run_config("adaptive_bucketed", trace, params, store, dev,
                                            buckets=(128, 1024), max_wait_s=wait),
        }
        if args.int8:
            out["adaptive_bucketed_int8"] = run_config(
                "int8", trace, params, store, dev, buckets=(128, 1024), max_wait_s=wait,
                weight_dtype="int8")
    out["p99_speedup"] = out["fixed"]["e2e_p99_ms"] / out["adaptive_bucketed"]["e2e_p99_ms"]
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()

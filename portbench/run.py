"""Run one benchmark cell on the card and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last: each
compared number beside its limit); the last lines of standard error give
the same numbers.  Without a CUDA card, or with fewer cards than the cell
asks for, it exits 1 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Every build and kernel cache inside the checkout, at fixed paths (the
# port's own nvcc builds go to build/repro_torch/ already).
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _power_limit() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else res.stderr.strip()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness
    from portbench.program import Program

    bench = harness.Bench()
    cell = bench.cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"needs {chips} CUDA card(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 1
    if torch.backends.cuda.matmul.allow_tf32:
        _log("TF32 matrix products are on in this process; the configuration states f32")
        return 1
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    result = harness.run(cell, bench, args.seed, args.seconds, bool(args.trace), device,
                         Program, T_START, log=_log)
    _log(f"card: {_power_limit()}; peaks 67 TFLOP/s f32, 3.35 TB/s (H100 SXM5 data sheet)")
    found = harness.forbidden_modules()
    if found:
        _log(f"modules of JAX or the JAX package are loaded: {found}")
        return 1
    for name, c in result["checks"].items():
        _log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Roofline analysis over the dry-run records, the port of
``repro.launch.roofline`` on one H100's figures (``launch/mesh``).

Reads the ``*.json`` records of ``launch/dryrun`` and derives the three
roofline terms per (arch x shape x mesh), each per device (the records
are per-device counts):

    compute    = FLOPs      / PEAK_FLOPS_BF16 (PEAK_FLOPS_F32 for an f32 config)
    memory     = bytes      / HBM_BW
    collective = coll_bytes / NVLINK_BW

plus MODEL_FLOPS = 6*N*D for a train step (2*N*D forward-only; N active
for a MoE) and the useful-compute ratio MODEL_FLOPS per device over the
counted FLOPs.  The dominant term is the bottleneck.  A 16 x 16 mesh of
H100s spans 32 eight-card nodes, and only a node's cards share NVLink; the
collective term takes NVLink's rate for every byte, so it is a lower
bound.  The memory term rests on the dry run's unfused byte count, an
upper bound on the traffic.

  PYTHONPATH=src python -m repro_torch.launch.roofline [--dir experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Any

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32


def flops_of(n_active: int, shape: ShapeConfig) -> float:
    """6 * N * D for a train step (forward and backward), 2 * N * D for a
    prefill, 2 * N * batch for one decode token a sequence."""
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def model_flops(arch: str, shape_name: str) -> float:
    """6 * N_active * D for train (fwd+bwd); 2 * N_active * D for fwd-only."""
    return flops_of(configs.get(arch).active_param_count(), configs.SHAPES[shape_name])


def analyse(rec: dict[str, Any]) -> dict[str, Any] | None:
    if rec.get("status") != "ok":
        return None
    chips = rec["chips"]
    corr = rec.get("corrected") or {}
    flops = corr.get("flops", rec["flops"])
    nbytes = corr.get("bytes_accessed", rec["bytes_accessed"])
    coll_total = corr.get("collective_total", rec["collectives"]["total"])
    # An f32 config computes outside the tensor cores.
    peak, peak_name = ((PEAK_FLOPS_F32, "f32") if rec["dtype"] == "float32"
                       else (PEAK_FLOPS_BF16, "bf16"))
    t_compute = flops / peak
    t_memory = nbytes / HBM_BW
    t_coll = coll_total / NVLINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = rec["model_flops"]
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": "x".join(str(x) for x in rec["mesh"]),
        "chips": chips,
        "peak": peak_name,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "bound_s": terms[dominant],
        "model_flops": mf,
        "hlo_flops": flops,
        # The per-device share of MODEL_FLOPS against the counted FLOPs.
        "useful_ratio": (mf / chips) / flops if flops else 0.0,
        "coll_bytes": coll_total,
        "peak_bytes_per_chip": (rec.get("memory") or {}).get("peak_bytes"),
    }


def load_all(directory: str, tag: str = "pod") -> list[dict[str, Any]]:
    rows = []
    for path in sorted(glob.glob(os.path.join(directory, f"*__{tag}.json"))):
        with open(path) as f:
            rec = json.load(f)
        row = analyse(rec)
        if row is not None:
            rows.append(row)
    return rows


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:7.2f}s "
    if x >= 1e-3:
        return f"{x * 1e3:7.2f}ms"
    return f"{x * 1e6:7.1f}us"


def table(rows: list[dict[str, Any]]) -> str:
    hdr = (
        f"{'arch':18s} {'shape':12s} {'mesh':8s} {'peak':>4s} "
        f"{'compute':>9s} {'memory':>9s} {'collective':>10s} "
        f"{'dominant':>10s} {'useful':>7s}"
    )
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r['arch']:18s} {r['shape']:12s} {r['mesh']:8s} {r['peak']:>4s} "
            f"{fmt_s(r['t_compute_s']):>9s} {fmt_s(r['t_memory_s']):>9s} "
            f"{fmt_s(r['t_collective_s']):>10s} "
            f"{r['dominant']:>10s} {r['useful_ratio']:6.1%}"
        )
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="pod")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    rows = load_all(args.dir, args.tag)
    print(table(rows))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()

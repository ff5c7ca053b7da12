"""Readings for the limits of a cell's comparison, at the cell's own size.

    python3 -m portbench.control --workload <cell> --seeds <n> ... [--control-seeds k]

For each seed it draws the cell's inputs, makes one program call and the
reference's f32 batch, and prints the numbers of ``check`` of the program against
the reference (the lower readings).  For the first ``--control-seeds``
seeds it also puts three stand-ins in the program's place, each judged by
the same numbers:

- ``control``: the reference with every matrix product in TF32, the
  nearest precision below the configuration's f32 (the upper readings);
- ``half``: the reference with the second half of each trial's clients
  left out of the fog reduce, its means taken over the rest;
- ``altered``: the program's own answer with trial 0's F1 moved by one
  flagged test row;
- ``ulp``: the reference itself from initial weights one ulp up, a
  witness of how far rounding alone carries each number.

A state left unchanged reads ``change_gap`` 1 by its definition and needs
no run.  The benchmark's own runs do not run this; it prints one JSON
line per seed and stand-in.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import check, harness
from portbench.reference import common as ref_common


def stand_in(cell, trials, ref, stacked_in, how: str, program_out=None) -> dict:
    """A stand-in's answer, judged against the reference's."""
    tel, params, _, _ = stacked_in
    flat0 = ref_common.ravel(params)
    if how in ("control", "half", "ulp"):
        summary, flat = _reference_variant(cell, trials, lowp=how == "control",
                                           half=how == "half", ulp=how == "ulp")
        out = {**summary, **ref_common.evaluate(flat, cell.dims, tel, cell.mix["percentile"],
                                             lowp=how == "control")}
    else:
        out = dict(program_out)
        flat = harness.program_flat(out)
        positives = tel.test_label.reshape(flat.shape[0], -1).sum(dim=-1).double()
        f1 = out["f1"].clone()
        f1[0] = f1[0] + 1.0 / float(positives[0])
        out["f1"] = f1
    ev = ref_common.evaluate(flat, cell.dims, tel, cell.mix["percentile"])
    return {**check.numbers(out, flat, ref, ev, flat0, cell.dims), **by_round(out, ref)}


def by_round(out: dict, ref: dict) -> dict:
    """The first rounds' loss gaps one by one (a diagnostic, not compared)."""
    return {"loss_gap_by_round": [check.rel_gap(out["losses"][..., t], ref["losses"][..., t])
                                  for t in range(check.LOSS_ROUNDS)]}


def _reference_variant(cell, trials, lowp: bool, half: bool, ulp: bool = False):
    tel, params, dep, draws = harness.stacked(trials)
    if ulp:
        params = [{"w": torch.nextafter(lay["w"], torch.full_like(lay["w"], float("inf"))),
                   "b": lay["b"]} for lay in params]
    if half:
        n = tel.n_samples.shape[-1]
        keep = (torch.arange(n, device=tel.n_samples.device) < n // 2).to(torch.float32)
        tel = tel._replace(n_samples=tel.n_samples * keep)
    flat, per_round = cell.method.train(cell.cfg, cell.reference_view(), tel, params, dep,
                                        draws, lowp=lowp)
    return ref_common.summary(per_round), flat


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    from portbench.program import Program

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    bench = harness.Bench()
    cell = bench.cell(args.workload)
    prog = None
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        trials = harness.draw(cell, seed, device)
        prog = prog or Program(cell.cfg, cell.mix, device)
        out = prog.call(prog.inputs(trials))
        torch.cuda.synchronize(device)
        ref, stacked_in = harness.reference(cell, trials)
        worst, _ = harness.judge(cell, [out], ref, stacked_in)
        loss_all = check.rel_gap(out["losses"], ref["losses"])
        rows = [("program", worst, {"loss_gap_all_rounds": loss_all, **by_round(out, ref)})]
        if i < args.control_seeds:
            for how in ("control", "half", "altered", "ulp"):
                rows.append((how, stand_in(cell, trials, ref, stacked_in, how, out), {}))
        for how, found, extra in rows:
            print(json.dumps({"cell": cell.name, "seed": seed, "side": how, **found, **extra,
                              "s": time.perf_counter() - t0}), flush=True)
        del out, ref, stacked_in, trials
    return 0


if __name__ == "__main__":
    sys.exit(main())

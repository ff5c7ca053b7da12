"""The comparison that decides ``correct``: a batch of trials from the
program against the reference's on the same inputs.

Four numbers, each the worst over the trials of the batch; a cell's
``limits/<cell>.json`` names the ones it compares:

- ``physics_gap``: the trial metrics that the round physics sets
  (participation, cooperation links, erasures, non-finite deltas, the
  three energies and their total, Eq. 21's latency), the largest
  relative gap.
- ``loss_gap``: the per-round mean client loss of the first
  ``LOSS_ROUNDS`` rounds, the largest relative gap.
- ``change_gap``: each leaf's change over the trial, ``||theta_T -
  theta_0||``, the gap between the program's norm and the reference's,
  over the reference's norm of that leaf or of the median leaf, whichever
  is larger; the worst leaf.  Leaves whose reference change is at most a
  thousandth of the median leaf's are left out: a bias that top-k has not
  yet picked up has not moved.
- ``eval_gap``: the program's F1, precision and recall against the
  reference's evaluation of the program's own trained params (threshold
  at the validation errors' percentile, then the test flags), the largest
  absolute gap.
"""
from __future__ import annotations

import math

import torch

LOSS_ROUNDS = 3
PHYSICS_KEYS = ("participation", "coop_links", "erased_total", "nonfinite_total", "e_s2f",
                "e_f2f", "e_f2g", "e_total", "sim_time_s")
NUMBERS = ("physics_gap", "loss_gap", "change_gap", "eval_gap")


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest relative gap |got - want| / |want| (0 where both agree)."""
    got, want = got.double(), want.double()
    gap = (got - want).abs()
    scale = want.abs()
    rel = torch.where(gap == 0, torch.zeros_like(gap), gap / torch.clamp_min(scale, 1e-30))
    return float(rel.max()) if rel.numel() else 0.0


def leaf_changes(flat: torch.Tensor, flat0: torch.Tensor, dims) -> torch.Tensor:
    """(B, leaves) norms of each leaf's change, leaves in the ravel order
    (per layer the bias, then the weight)."""
    out, off = [], 0
    diff = (flat - flat0).double()
    for a, b in zip(dims[:-1], dims[1:]):
        for size in (b, a * b):
            out.append(torch.linalg.vector_norm(diff[:, off:off + size], dim=-1))
            off += size
    return torch.stack(out, dim=-1)


def leaf_gaps(flat: torch.Tensor, ref_flat: torch.Tensor, flat0: torch.Tensor, dims):
    """(B, leaves) gaps of the leaves' change norms, and which leaves
    count (reference change above a thousandth of the median leaf's)."""
    got = leaf_changes(flat, flat0, dims)
    want = leaf_changes(ref_flat, flat0, dims)
    median = torch.median(want, dim=-1, keepdim=True).values
    counted = want > 1e-3 * median                # a leaf the reference leaves unmoved is out
    diff, denom = (got - want).abs(), torch.maximum(want, median)
    gap = torch.where(denom > 0, diff / torch.where(denom > 0, denom, 1.0),
                      torch.where(diff == 0, 0.0, math.inf))
    return gap, counted


def change_gap(flat, ref_flat, flat0, dims) -> float:
    gap, counted = leaf_gaps(flat, ref_flat, flat0, dims)
    return float(torch.where(counted, gap, 0.0).max())


def numbers(out: dict, flat: torch.Tensor, ref: dict, ref_eval: dict, flat0: torch.Tensor,
            dims) -> dict[str, float]:
    """The four numbers of one batch: ``out`` the program's (or a
    stand-in's) result dict, ``flat`` its trained params (B, d), ``ref``
    the reference's summary and ``"flat"``, ``ref_eval`` the reference's
    evaluation of ``flat``, ``flat0`` the initial params."""
    physics = max(rel_gap(out[k], ref[k]) for k in PHYSICS_KEYS)
    loss = rel_gap(out["losses"][..., :LOSS_ROUNDS], ref["losses"][..., :LOSS_ROUNDS])
    evals = max(float((out[k].double() - ref_eval[k].double()).abs().max())
                for k in ("f1", "precision", "recall"))
    return {"physics_gap": physics, "loss_gap": loss,
            "change_gap": change_gap(flat, ref["flat"], flat0, dims), "eval_gap": evals}


def verdict(found: dict[str, float], limits: dict[str, float]) -> bool:
    """Every number the limits name within its limit (a number at its
    limit passes; NaN fails)."""
    return all(found[k] <= limits[k] for k in limits)

"""What every method's reference shares: the flat parameter layout, the
gateway's weighted mean, the uplink payload, the trial summary and the
detector's evaluation (Sec. V-D), in plain PyTorch.

Frozen from ``src/repro_torch/core/hfl.py``, ``core/aggregation.py`` and
``launch/experiment.py`` at commit 503575e07401e7f10a9c0026dea9d563d82ebbba;
it imports nothing of the program.
"""
from __future__ import annotations

import math

import torch

from . import plain


def ravel(params: list[dict]) -> torch.Tensor:
    """(B, d): per layer the bias, then the row-major weight."""
    b_n = params[0]["b"].shape[0]
    return torch.cat([t.reshape(b_n, -1) for layer in params for t in (layer["b"], layer["w"])],
                     dim=-1)


def unravel(flat: torch.Tensor, dims: tuple[int, ...]) -> list[dict]:
    out, off = [], 0
    for a, b in zip(dims[:-1], dims[1:]):
        out.append({"b": flat[:, off:off + b],
                    "w": flat[:, off + b:off + b + a * b].reshape(-1, a, b)})
        off += b + a * b
    return out


def payload_bits(d: int, comp: dict) -> float:
    """Eq. 31: K (b_q + ceil(log2 d)) bits with K = max(1, round(rho_s d))."""
    k = max(1.0, round(comp["rho_s"] * d))
    return k * (float(comp["quant_bits"]) + math.ceil(math.log2(max(d, 2))))


def weighted_mean(updates, weights, prev, lowp: bool):
    """The gateway's data-weighted mean of the (B, M, d) fog models, each
    trial its own (1, M) x (M, d) product; ``prev`` where a trial's round
    carried no weight."""
    total = torch.sum(weights, dim=-1)
    w = weights / torch.clamp_min(total, 1e-12)[..., None]
    if updates.is_cuda:
        out = torch.cat([plain.matmul(a, b, lowp)
                         for a, b in zip(w.reshape(-1, 1, w.shape[-1]), updates)])
    else:
        out = plain.matmul(w.unsqueeze(-2), updates, lowp).squeeze(-2)
    return torch.where((total > 0.0)[..., None], out, prev)


def summary(m: dict) -> dict:
    """The trial's metrics from its per-round ones, as the program's
    experiment runner reports them (sums and means over the rounds)."""
    return {
        "e_total": torch.sum(m["e_total"], dim=0),
        "e_s2f": torch.sum(m["e_s2f"], dim=0),
        "e_f2f": torch.sum(m["e_f2f"], dim=0),
        "e_f2g": torch.sum(m["e_f2g"], dim=0),
        "participation": torch.mean(m["participation"], dim=0),
        "coop_links": torch.mean(m["coop_links"].to(torch.float32), dim=0),
        "losses": torch.movedim(m["loss"], 0, -1),
        "sim_time_s": torch.sum(m["latency_s"], dim=0),
        "nonfinite_total": torch.sum(m["n_nonfinite"].to(torch.float32), dim=0),
        "erased_total": torch.sum(m["n_erased"].to(torch.float32), dim=0),
        "nonfinite_rounds": torch.sum(1.0 - m["global_finite"].to(torch.float32), dim=0),
    }


def evaluate(flat: torch.Tensor, dims, data, percentile: float, lowp: bool = False) -> dict:
    """Each trial's threshold (the ``percentile`` of its validation
    errors, interpolated linearly) and its point-wise F1, precision and
    recall on its test rows, from its params (B, d)."""
    layers = unravel(flat, dims)
    b_n, d_in = flat.shape[0], dims[0]

    def errors(x):
        h = x
        for i, lay in enumerate(layers):
            h = plain.matmul(h, lay["w"], lowp) + lay["b"].unsqueeze(-2)
            if i < len(layers) - 1:
                h = torch.tanh(h)
        return torch.sum(torch.square(x - h), dim=-1)

    tau = torch.quantile(errors(data.val.reshape(b_n, -1, d_in)), percentile / 100.0, dim=-1)
    pred = (errors(data.test.reshape(b_n, -1, d_in)) > tau[..., None]).to(torch.float32)
    label = data.test_label.reshape(b_n, -1).to(torch.float32)
    tp = torch.sum(pred * label, dim=-1)
    fp = torch.sum(pred * (1.0 - label), dim=-1)
    fn = torch.sum((1.0 - pred) * label, dim=-1)
    precision = tp / torch.clamp(tp + fp, min=1e-12)
    recall = tp / torch.clamp(tp + fn, min=1e-12)
    f1 = 2.0 * precision * recall / torch.clamp(precision + recall, min=1e-12)
    return {"f1": f1, "precision": precision, "recall": recall, "tau": tau}

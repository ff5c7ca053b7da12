"""Fault injection for hostile acoustic deployments: lossy links,
crashing sensors, Byzantine clients.

Semantics, as the round loop (``core/hfl``) applies them:

* **Crash** — a per-round Bernoulli(``crash_prob``) draw removes a client
  exactly like a dead battery: no training, no transmission, no energy.
* **Byzantine** — the first ~``byz_frac * N`` clients are adversarial
  (:func:`byzantine_mask`).  Their raw deltas are corrupted
  before compression: ``sign_flip`` sends ``-byz_scale * delta``,
  ``gauss`` sends ``byz_scale * N(0, I)``, ``inflate`` sends
  ``byz_scale * delta``, and ``adaptive`` colluders all send
  ``mu - byz_scale * sigma * dirn`` (the honest batch mean and population
  std, ``dirn`` opposing the previous global movement).
* **Erasure** — after SNR feasibility, a transmitted packet is lost with
  probability ``erasure_prob``: the transmit energy is still charged and
  the client's error-feedback buffer still advances; only its
  aggregation weight vanishes.

Randomness is an argument: the crash and erasure draws are f32 uniforms
and the ``gauss`` noise f32 normals, injected by the caller
(``hfl.RoundDraws``).  The f32 thresholds and scales are CPU scalars, so
a round on the card copies nothing to it (a copy would sync the host).
In a config sweep (``Engine.sweep``) the probabilities, ``byz_frac`` and
``byz_scale`` may instead be (B,) tensors of per-trial values on the
draws' device, each trial compared and scaled with its own.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.channel import per_trial

BYZ_MODES = ("none", "sign_flip", "gauss", "inflate", "adaptive")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Fault-injection knobs; ``active`` pins the on/off predicate (None:
    derive it from the other fields)."""

    erasure_prob: float = 0.0    # P(uplink packet lost | feasible)
    crash_prob: float = 0.0      # P(client crashes this round)
    byz_frac: float = 0.0        # fraction of adversarial clients
    byz_scale: float = 1.0       # attack magnitude (mode-dependent)
    byz_mode: str = "none"       # one of BYZ_MODES
    active: bool | None = None

    def __post_init__(self) -> None:
        if self.byz_mode not in BYZ_MODES:
            raise ValueError(f"byz_mode must be one of {BYZ_MODES}, got {self.byz_mode!r}")
        for name in ("erasure_prob", "crash_prob", "byz_frac"):
            v = getattr(self, name)
            if isinstance(v, (int, float)) and not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be a probability in [0, 1], got {v!r}")

    def replace(self, **kw: Any) -> "FaultConfig":
        # Changing a probability or the mode re-derives the predicate
        # unless the caller pins it.
        if "active" not in kw and any(
            f in kw for f in ("erasure_prob", "crash_prob", "byz_frac", "byz_mode")
        ):
            kw["active"] = None
        return dataclasses.replace(self, **kw)

    @property
    def is_active(self) -> bool:
        """Whether the round loop runs the fault layer: a pinned value
        wins; otherwise any Byzantine mode, any nonzero probability or any
        per-trial (tensor) one.  When False the round is exactly the
        fault-free round."""
        if self.active is not None:
            return self.active
        if self.byz_mode != "none":
            return True
        return any(isinstance(p, torch.Tensor) or p > 0.0
                   for p in (self.erasure_prob, self.crash_prob, self.byz_frac))


def byzantine_mask(
    n: int, byz_frac: Any, device: torch.device | str | None = None,
) -> torch.Tensor:
    """(N,) bool: client i is Byzantine when ``(i + 0.5) / n < byz_frac``
    in f32, the first ``ceil(byz_frac * n - 1/2)`` clients; (B, N) for a
    (B,) tensor of per-trial fractions, each trial's own first clients."""
    pos = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n
    if isinstance(byz_frac, torch.Tensor):
        return pos < byz_frac[..., None]
    frac = torch.tensor(byz_frac, dtype=torch.float32)      # a CPU scalar: no copy to the card
    return pos < frac


def corrupt_deltas(
    deltas: torch.Tensor,                  # (..., N, d) raw flat client updates
    cfg: FaultConfig,
    prev_delta: torch.Tensor | None = None,  # (..., d) last global delta (adaptive)
    noise: torch.Tensor | None = None,       # (..., N, d) f32 standard normals (gauss)
) -> torch.Tensor:
    """The configured Byzantine behaviour applied to the delta stream,
    before compression.  ``adaptive`` takes the mean and the population
    std (ddof 0) over all N rows; without ``prev_delta`` (or where it is
    0) the direction is ``sign(mu)``.  Leading axes are trials: each has
    its own colluders (its first clients) and its own statistics."""
    if cfg.byz_mode == "none":
        return deltas
    mask = byzantine_mask(deltas.shape[-2], cfg.byz_frac, deltas.device)
    scale = (per_trial(cfg.byz_scale, deltas) if isinstance(cfg.byz_scale, torch.Tensor)
             else torch.tensor(cfg.byz_scale, dtype=torch.float32))  # CPU scalar: no copy
    if cfg.byz_mode == "sign_flip":
        attacked = -scale * deltas
    elif cfg.byz_mode == "gauss":
        if noise is None or noise.shape != deltas.shape:
            raise ValueError(f"gauss needs (N, d) = {tuple(deltas.shape)} normals, got "
                             f"{None if noise is None else tuple(noise.shape)}")
        attacked = scale * noise
    elif cfg.byz_mode == "adaptive":
        if prev_delta is None:
            prev_delta = torch.zeros(deltas.shape[-1], dtype=deltas.dtype, device=deltas.device)
        mu = torch.mean(deltas, dim=-2)
        sigma = torch.std(deltas, dim=-2, correction=0)
        dirn = torch.where(prev_delta == 0.0, torch.sign(mu), torch.sign(prev_delta))
        s_mu = scale[..., 0] if isinstance(cfg.byz_scale, torch.Tensor) else scale
        attacked = torch.broadcast_to((mu - s_mu * sigma * dirn).unsqueeze(-2), deltas.shape)
    else:  # inflate
        attacked = scale * deltas
    return torch.where(mask[..., None], attacked, deltas)


def _threshold(uniform: torch.Tensor, prob: Any) -> torch.Tensor:
    """``uniform < prob``: a (B,) tensor of per-trial probabilities against
    (B, N) uniforms, else a CPU scalar."""
    if isinstance(prob, torch.Tensor):
        return uniform < per_trial(prob, uniform)
    return uniform < torch.tensor(prob, dtype=torch.float32)


def draw_crash(uniform: torch.Tensor, crash_prob: Any) -> torch.Tensor:
    """(N,) bool crash mask from (N,) f32 uniforms in [0, 1)."""
    return _threshold(uniform, crash_prob)


def draw_erasure(uniform: torch.Tensor, erasure_prob: Any) -> torch.Tensor:
    """(N,) bool packet-erasure mask from (N,) f32 uniforms, applied after
    SNR feasibility."""
    return _threshold(uniform, erasure_prob)


def nonfinite_rows(deltas: torch.Tensor) -> torch.Tensor:
    """(N,) bool — rows carrying any NaN/Inf coordinate."""
    return ~torch.all(torch.isfinite(deltas), dim=-1)

"""Dynamic-world knobs: mid-training drift and periodic re-association.

Semantics (threaded through the round loop of ``core/hfl.py``):

* **Sensor current advection**: a deterministic depth-sheared horizontal
  current (``topology.current_advection_step``) moves the sensors each
  round; the fogs keep their Gauss-Markov walk (``fog_mobility``).  The
  layer draws nothing, so ``hfl.draw_rounds`` is the same with drift on or
  off.
* **Periodic re-association**: the sensor->fog assignment is carried in
  the round state and refreshed from the live geometry only every
  ``reassoc_every`` rounds (``1`` = every round, the drift-off behaviour;
  ``inf`` = frozen after round 0).  Between refreshes the stale
  assignment meets the live physics (``association.assigned_fog_association``):
  a sensor whose assigned fog drifted out of range drops out.
* **Covariate shift**: client training inputs are scaled by
  ``1 + covariate_shift * round`` inside the loop.

The reference's ``repro.core.drift.DriftConfig`` is a pytree whose rates
can be traced through a batched sweep.  Here it is a plain frozen
dataclass with the same fields, validation and ``is_active`` rule; in a
config sweep (``Engine.sweep``) a rate may be a (B,) tensor of per-trial
values, which the validation lets pass as the reference lets a traced
one.
"""
from __future__ import annotations

import dataclasses
from typing import Any

_RATE_FIELDS = ("sensor_current_m_s", "reassoc_every", "covariate_shift")


def _concrete(x: Any) -> bool:
    """A plain number (not a tensor of per-trial values)."""
    return isinstance(x, (int, float))


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Dynamic-world knobs; ``active`` pins the on/off switch (None =
    derive it from the rates)."""

    sensor_current_m_s: float = 0.0   # horizontal advection speed
    reassoc_every: float = 1.0        # re-association cadence (rounds)
    covariate_shift: float = 0.0      # per-round input-scale drift
    active: bool | None = None

    def __post_init__(self) -> None:
        if _concrete(self.sensor_current_m_s) and self.sensor_current_m_s < 0:
            raise ValueError(
                f"sensor_current_m_s must be >= 0, got {self.sensor_current_m_s!r}")
        if _concrete(self.reassoc_every) and self.reassoc_every < 1:
            raise ValueError(f"reassoc_every must be >= 1 round, got {self.reassoc_every!r}")

    def replace(self, **kw: Any) -> "DriftConfig":
        # Changing a rate re-derives the switch unless the caller pins it.
        if "active" not in kw and any(f in kw for f in _RATE_FIELDS):
            kw["active"] = None
        return dataclasses.replace(self, **kw)

    @property
    def is_active(self) -> bool:
        """The drift-layer switch: a pinned value wins; otherwise a nonzero
        rate, a cadence other than 1 or any per-trial (tensor) rate turns
        the layer on.  Off, the round is exactly the drift-free one."""
        if self.active is not None:
            return self.active
        rates = (self.sensor_current_m_s, self.covariate_shift)
        if any(not _concrete(r) or r != 0.0 for r in rates):
            return True
        return not _concrete(self.reassoc_every) or self.reassoc_every != 1.0

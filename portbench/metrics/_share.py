"""What the roofline readers share: a trace that kept every launch, and
the bound over the measured device time as a percentage."""
from __future__ import annotations


def complete_trace(ctx):
    """The run's trace when it kept every launch of the port's kernels,
    else None."""
    tr = ctx.trace
    return tr if tr is not None and tr.complete else None


def roofline(bound_s: float, device_s: float) -> float | None:
    return None if device_s <= 0.0 else 100.0 * bound_s / device_s

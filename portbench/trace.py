"""A device trace of whole calls: torch.profiler's CUPTI activities, the
check that it kept every launch of the port's kernels, and the breakdown
the result line carries.

The port counts its launches by wrapper (``LAUNCHES``): ``fused_agg``
adds one for each of its two device kernels, ``robust_agg`` one for its
two (member lists, reduce), the others one for one.  Each device kernel
of the port has a file ``kernels/<device kernel name>.json`` naming its
counter and its device launches per count; ``KERNELS`` holds them all.
"""
from __future__ import annotations

import bisect
import json
import re
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

KERNEL_DIR = Path(__file__).resolve().parent / "kernels"


def load_kernels(kernel_dir: Path = KERNEL_DIR) -> dict[str, tuple[str, float]]:
    """Device kernel name -> (launch counter, device launches per count)."""
    out = {}
    for path in sorted(kernel_dir.glob("*.json")):
        spec = json.loads(path.read_text())
        out[path.stem] = (spec["counter"], float(spec["launches_per_count"]))
    return out


KERNELS = load_kernels()
_PATTERNS = {k: re.compile(rf"(?<![A-Za-z0-9_]){k}(?![A-Za-z0-9_])") for k in KERNELS}
TOP = 10
NAME_CHARS = 160  # a device op's name in the breakdown, cut (template arguments run long)
SCAN = 512       # host ops looked back through for the one running in a gap


def kernel_of(name: str) -> str | None:
    """The port kernel a device activity belongs to, or None."""
    for k, pat in _PATTERNS.items():
        if pat.search(name):
            return k
    return None


@dataclass
class Trace:
    """Device activities (name, start s, end s) and host ops of ``calls``
    traced calls of ``rounds`` rounds each, in ``window_s`` seconds."""

    device: list[tuple[str, float, float]]
    host: list[tuple[str, float, float]]
    launches: dict[str, int]
    calls: int
    rounds: int
    window_s: float
    kept: dict[str, tuple[int, int]] = field(default_factory=dict)   # kernel -> (kept, launched)

    @property
    def complete(self) -> bool:
        return all(k == n for k, n in self.kept.values())

    def kernel_seconds(self, kernel: str) -> tuple[float, int]:
        """(device seconds, activities) of one port kernel."""
        spans = [e - s for name, s, e in self.device if kernel_of(name) == kernel]
        return sum(spans), len(spans)

    def busy_s(self) -> float:
        """Seconds in which any activity ran on the card (the union)."""
        total, end = 0.0, float("-inf")
        for _, s, e in sorted(self.device, key=lambda a: a[1]):
            if s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total

    def gaps(self) -> list[tuple[float, float]]:
        """The idle stretches between the device activities."""
        out, end = [], None
        for _, s, e in sorted(self.device, key=lambda a: a[1]):
            if end is not None and s > end:
                out.append((end, s))
            end = e if end is None else max(end, e)
        return out

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps summed by the innermost host op running at their middle."""
        by_op: dict[str, float] = {}
        for name, s, e in self.device:
            short = name[:NAME_CHARS]
            by_op[short] = by_op.get(short, 0.0) + (e - s)
        by_host: dict[str, float] = {}
        host = sorted((h for h in self.host if not h[0].startswith("cuda")),
                      key=lambda a: a[1])
        starts = [h[1] for h in host]
        for s, e in self.gaps():
            mid = 0.5 * (s + e)
            at = bisect.bisect_right(starts, mid)
            inner = [h for h in host[max(0, at - SCAN):at] if h[2] >= mid]
            name = min(inner, key=lambda h: h[2] - h[1])[0] if inner else "host (no op)"
            by_host[name] = by_host.get(name, 0.0) + (e - s)
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


def capture(call, calls: int, rounds: int, launches, device: torch.device) -> Trace:
    """Trace ``calls`` calls of ``call`` (each ending at a synchronise)
    under torch.profiler, and count what it kept of each port kernel
    against the launch counters."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        activities.append(ProfilerActivity.CUDA)
    before = launches()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        window_s = time.perf_counter() - t0
    after = launches()
    delta = {k: after[k] - before.get(k, 0) for k in after}
    device, host = [], []
    for ev in prof.events():
        span = (ev.name, ev.time_range.start / 1e6, ev.time_range.end / 1e6)
        (device if ev.device_type == DeviceType.CUDA else host).append(span)
    tr = Trace(device, host, delta, calls, rounds, window_s)
    for kernel, (counter, per) in KERNELS.items():
        launched = round(delta.get(counter, 0) * per)
        kept = tr.kernel_seconds(kernel)[1]
        if launched or kept:
            tr.kept[kernel] = (kept, launched)
    return tr

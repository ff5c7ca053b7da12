"""Production load generation: seeded arrival traces + open-loop replay.

``traces``  — Poisson / bursty MMPP / diurnal arrival-trace generators
              (deterministic, pure numpy);
``harness`` — virtual-clock open-loop replay driving a ``ScoringService``
              or ``MultiTenantService`` and recording true end-to-end
              per-request latency (queue wait + batch formation + device
              time).
"""
from repro_torch.loadgen.harness import (  # noqa: F401
    ReplayReport,
    VirtualClock,
    gaussian_windows,
    replay,
)
from repro_torch.loadgen.traces import (  # noqa: F401
    ArrivalTrace,
    diurnal_trace,
    mmpp_trace,
    poisson_trace,
)

"""Fleet-scale online anomaly-scoring service (the paper's end product).

``score``     — fused AE-forward + error + threshold compare hot path
                (CUDA kernel on the Hopper card, plain PyTorch on the CPU);
``calibrate`` — streaming per-fog / global threshold reservoirs;
``service``   — micro-batching request loop with double-buffered param
                hot-swap off a ``checkpoint.CheckpointStore``;
``tenancy``   — many deployments sharing one set of score programs.
"""
from repro_torch.serving.calibrate import (  # noqa: F401
    ReservoirState,
    StreamingCalibrator,
)
from repro_torch.serving.score import (  # noqa: F401
    ScoreResult,
    default_device,
    dequantize_params,
    fleet_tau,
    quantize_params,
    score,
    score_fleet,
    score_q8,
)
from repro_torch.serving.service import (  # noqa: F401
    ScorePrograms,
    ScoringService,
    ServiceStats,
)
from repro_torch.serving.tenancy import MultiTenantService  # noqa: F401

from repro_torch.core import anomaly  # noqa: F401

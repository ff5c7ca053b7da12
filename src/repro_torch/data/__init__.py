from repro_torch.data import synthetic  # noqa: F401

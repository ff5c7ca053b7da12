from repro_torch.models import autoencoder  # noqa: F401

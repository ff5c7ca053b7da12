"""Device resolution shared by the port's entry points.

``device=None`` means the Hopper card: the current CUDA device, which is
``cuda:0`` unless the process chose another by
``torch.cuda.set_device`` (one rank per card under ``torchrun``: rank r
sets its local rank's card before its first launch).  Nothing falls back
to the CPU when no card is found: the caller asks for ``device="cpu"``
explicitly.
"""
from __future__ import annotations

import torch

REQUIRED_CAPABILITY = (9, 0)   # the kernels are built for sm_90a only


def default_device() -> torch.device:
    """The current CUDA device when it is a Hopper card; raises otherwise."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device; pass device='cpu' to run the plain PyTorch path"
        )
    cap = torch.cuda.get_device_capability()    # the current device's
    if tuple(cap) != REQUIRED_CAPABILITY:
        raise RuntimeError(
            f"the current CUDA device has capability {cap}, the kernels need "
            f"{REQUIRED_CAPABILITY} (sm_90a)"
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device: torch.device | str | None) -> torch.device:
    """``None`` -> :func:`default_device`; anything else as given."""
    return default_device() if device is None else torch.device(device)

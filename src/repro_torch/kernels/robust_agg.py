"""Launch wrapper of the robust-aggregation kernel (``csrc/robust_agg.cu``).

:func:`robust_aggregate_blocks` takes CUDA tensors only: the (N, d)
per-client reconstructions, the (N,) fog assignment and weights.  It
checks them, lists every fog's members (weight > 0) in index order as one
compacted array with per-fog offsets (:func:`member_lists`, so the
kernel reads only its own fog's ids and takes any fleet and fog size),
allocates the (n_fog, d) output with ``torch.empty`` and launches the
kernel once on the current stream, adding one to
``LAUNCHES["robust_agg"]``.  The CPU route is ``kernels/ops``', which
sends CPU tensors to ``kernels/ref.robust_aggregate_ref``, the plain
version of the same function.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _launch

LAUNCHES = {"robust_agg": 0}
MAX_BETA = 0.4995             # trim fractions are clamped to [0, MAX_BETA]

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    LAUNCHES["robust_agg"] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("robust_agg")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.robust_agg.argtypes = [vp, vp, vp, vp, i, i, ctypes.c_float, i, vp, vp]
        lib.robust_agg.restype = i
        lib.robust_agg_error_string.argtypes = [i]
        lib.robust_agg_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def member_lists(fog_id: torch.Tensor, weights: torch.Tensor,
                 n_fog: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The fogs' members as one compacted list: (members (N,) int32,
    offsets (n_fog + 1,) int32), fog m's clients of weight > 0 being
    members[offsets[m]:offsets[m + 1]] in index order.  A stable sort of
    the fog ids (non-members keyed past the last fog) and a binary search
    of the fog boundaries: no host sync, O(N log N)."""
    keys, order = torch.sort(torch.where(weights > 0, fog_id, n_fog), stable=True)
    bounds = torch.arange(n_fog + 1, dtype=keys.dtype, device=keys.device)
    return order.to(torch.int32), torch.searchsorted(keys, bounds, out_int32=True)


def robust_aggregate_blocks(
    recon: torch.Tensor,      # (N, d) f32 per-client reconstructions
    fog_id: torch.Tensor,     # (N,) int32 cluster assignment
    weights: torch.Tensor,    # (N,) f32, zeroed for non-participants
    n_fog: int,
    beta: float,              # trim fraction (trimmed); ignored by the median
    mode: str = "trimmed",
) -> torch.Tensor:
    """Launch the kernel: the NORMALISED robust aggregate per fog, (n_fog,
    d) f32, zeros for empty fogs.  ``beta`` goes to the kernel as an f32
    and is clamped there, as the plain version clamps it."""
    device = _launch.require_cuda(recon, "robust aggregation")
    if mode not in ("trimmed", "median"):
        raise ValueError(f"robust mode must be 'trimmed' or 'median', got {mode!r}")
    if recon.dim() != 2:
        raise ValueError(f"recon must be (N, d), got {tuple(recon.shape)}")
    n, d = (int(s) for s in recon.shape)
    if n < 1 or d < 1 or n_fog < 1:
        raise ValueError(f"needs N, d, n_fog >= 1, got N={n}, d={d}, n_fog={n_fog}")
    _launch.check(recon, "recon", torch.float32, (n, d), device)
    _launch.check(fog_id, "fog_id", torch.int32, (n,), device)
    _launch.check(weights, "weights", torch.float32, (n,), device)
    members, offsets = member_lists(fog_id, weights, n_fog)
    out = torch.empty((n_fog, d), dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        rc = lib.robust_agg(
            recon.data_ptr(), members.data_ptr(), offsets.data_ptr(), weights.data_ptr(), d,
            n_fog, float(beta), int(mode == "median"), out.data_ptr(), _launch.stream(device),
        )
        _launch.raise_on(rc, "robust_agg launch", lib.robust_agg_error_string)
        LAUNCHES["robust_agg"] += 1
    return out

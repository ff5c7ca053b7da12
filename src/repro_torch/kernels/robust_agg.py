"""Launch wrapper of the robust-aggregation kernel (``csrc/robust_agg.cu``).

:func:`robust_aggregate_blocks` takes CUDA tensors only: the (N, d)
per-client reconstructions, the (N,) fog assignment and weights.  It
checks them, allocates the (n_fog, d) output and the member lists with
``torch.empty`` and makes two launches on the current stream: the first
lists every fog's members (weight > 0) in index order as one compacted
array with per-fog offsets (:func:`member_lists_blocks`, a block per
fog, so the reduce reads only its own fog's ids and takes any fleet and
fog size), the second is the robust reduce.  Each call adds one to
``LAUNCHES["robust_agg"]``.  The CPU route is ``kernels/ops``', which
sends CPU tensors to ``kernels/ref.robust_aggregate_ref``, the plain
version of the same function.  :func:`member_lists` is the plain version
of the lists; the card's equal it element for element.
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
        lib.robust_agg_members.argtypes = [vp, vp, i, i, vp, vp, vp]
        lib.robust_agg_members.restype = i
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
    members[offsets[m]:offsets[m + 1]] in index order, and the clients of
    no fog (weight <= 0, or an id outside [0, n_fog)) after offsets[n_fog],
    in index order.  A stable sort of the fog ids (non-members keyed
    n_fog) and a binary search of the fog boundaries: no host sync, O(N
    log N)."""
    member = (weights > 0) & (fog_id >= 0) & (fog_id < n_fog)
    keys, order = torch.sort(torch.where(member, fog_id, n_fog), stable=True)
    bounds = torch.arange(n_fog + 1, dtype=keys.dtype, device=keys.device)
    return order.to(torch.int32), torch.searchsorted(keys, bounds, out_int32=True)


def _checked(fog_id: torch.Tensor, weights: torch.Tensor, n: int, n_fog: int,
             device: torch.device) -> None:
    if n < 1 or not 1 <= n_fog < 0x7FFFFFFF:
        raise ValueError(f"needs N >= 1 and 1 <= n_fog < 2^31 - 1, got N={n}, n_fog={n_fog}")
    _launch.check(fog_id, "fog_id", torch.int32, (n,), device)
    _launch.check(weights, "weights", torch.float32, (n,), device)


def _launch_members(lib: ctypes.CDLL, fog_id: torch.Tensor, weights: torch.Tensor, n: int,
                    n_fog: int, device: torch.device) -> torch.Tensor:
    """The member list (N) and the offsets (n_fog + 1) in one int32 tensor."""
    lists = torch.empty((n + n_fog + 1,), dtype=torch.int32, device=device)
    rc = lib.robust_agg_members(fog_id.data_ptr(), weights.data_ptr(), n, n_fog,
                                lists.data_ptr(), lists.data_ptr() + 4 * n, _launch.stream(device))
    _launch.raise_on(rc, "robust_agg member-list launch", lib.robust_agg_error_string)
    return lists


def member_lists_blocks(fog_id: torch.Tensor, weights: torch.Tensor,
                        n_fog: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the member-list kernel alone (the first of
    :func:`robust_aggregate_blocks`' two launches): :func:`member_lists`'
    (members, offsets), built on the card."""
    device = _launch.require_cuda(fog_id, "robust member-list")
    n = int(fog_id.numel())
    _checked(fog_id, weights, n, n_fog, device)
    lib = _library()
    with torch.cuda.device(device):
        lists = _launch_members(lib, fog_id, weights, n, n_fog, device)
    return lists[:n], lists[n:]


def robust_aggregate_blocks(
    recon: torch.Tensor,      # (N, d) f32 per-client reconstructions
    fog_id: torch.Tensor,     # (N,) int32 cluster assignment
    weights: torch.Tensor,    # (N,) f32, zeroed for non-participants
    n_fog: int,
    beta: float,              # trim fraction (trimmed); ignored by the median
    mode: str = "trimmed",
) -> torch.Tensor:
    """Launch the member lists, then the reduce: the NORMALISED robust
    aggregate per fog, (n_fog, d) f32, zeros for empty fogs.  ``beta`` goes
    to the kernel as an f32 and is clamped there, as the plain version
    clamps it."""
    device = _launch.require_cuda(recon, "robust aggregation")
    if mode not in ("trimmed", "median"):
        raise ValueError(f"robust mode must be 'trimmed' or 'median', got {mode!r}")
    if recon.dim() != 2:
        raise ValueError(f"recon must be (N, d), got {tuple(recon.shape)}")
    n, d = (int(s) for s in recon.shape)
    if d < 1:
        raise ValueError(f"needs d >= 1, got d={d}")
    _checked(fog_id, weights, n, n_fog, device)
    _launch.check(recon, "recon", torch.float32, (n, d), device)
    out = torch.empty((n_fog, d), dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        lists = _launch_members(lib, fog_id, weights, n, n_fog, device)
        members = lists.data_ptr()
        rc = lib.robust_agg(
            recon.data_ptr(), members, members + 4 * n, weights.data_ptr(), d, n_fog,
            float(beta), int(mode == "median"), out.data_ptr(), _launch.stream(device),
        )
        _launch.raise_on(rc, "robust_agg launch", lib.robust_agg_error_string)
        LAUNCHES["robust_agg"] += 1
    return out

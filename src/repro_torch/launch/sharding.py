"""The client mesh: the federated round loop's client axis over a
``torch.distributed`` process group.

One process per card, in the ``torchrun`` idiom: every rank runs the same
round on replicated state, and only the client phase is sliced.  Rank r
holds clients ``[r * N / W, (r + 1) * N / W)`` of the fleet's N and adds
its partial fog sums into everyone's by ``all_reduce``, the reference's
``psum`` over its ``("data",)`` mesh axis.  The round path uses
``all_reduce`` alone: gloo implements only ``all_reduce`` and
``broadcast`` for CUDA tensors, so two ranks can share one card over gloo
and the CPU tests run over gloo too.  Per-client values go back to a
whole axis by :meth:`ClientMesh.gather_rows`, an ``all_reduce`` of a
zero-filled buffer into which each rank writes its own slice: adding
zeros is exact, so every rank holds the same bits.

Each rank calls ``torch.cuda.set_device(local_rank)`` before its first
launch: ``device.default_device()`` is then that rank's card.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ClientMesh:
    """A process group that slices the client axis: this process's
    ``rank`` of ``size`` in ``group`` (None: the default group)."""

    group: Any
    rank: int
    size: int

    @property
    def axis_names(self) -> tuple[str]:
        return ("data",)

    def rows(self, n: int) -> slice:
        """This rank's slice of ``n`` clients; raises unless ``size``
        divides ``n``."""
        if n % self.size:
            raise ValueError(f"client axis ({n} sensors) must divide the "
                             f"({self.size})-rank client mesh")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group, in place; returns ``t``.  A view
        that is not contiguous (the plain fog sums' unpadded columns) is
        reduced through a contiguous copy: the collective reads and
        writes the storage as if it were dense."""
        buf = t if t.is_contiguous() else t.contiguous()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        if buf is not t:
            t.copy_(buf)
        return t

    def gather_rows(self, local: torch.Tensor, n: int, dim: int = -1) -> torch.Tensor:
        """Every rank's ``local`` slice (this rank's :meth:`rows` of ``n``
        along ``dim``) put together into the whole axis on every rank."""
        dim = dim % local.dim()
        shape = list(local.shape)
        shape[dim] = n
        out = torch.zeros(shape, dtype=local.dtype, device=local.device)
        out.narrow(dim, self.rows(n).start, local.shape[dim]).copy_(local)
        return self.sum_(out)


def client_mesh(group: Any = None) -> ClientMesh:
    """The client mesh over ``group`` (None: the default group, every
    rank); raises ``RuntimeError`` when ``torch.distributed`` is not
    initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("client_mesh needs an initialised torch.distributed process group "
                           "(torch.distributed.init_process_group, or torchrun)")
    return ClientMesh(group, dist.get_rank(group), dist.get_world_size(group))

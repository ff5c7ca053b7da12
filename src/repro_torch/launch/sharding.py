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

The same ``ClientMesh`` is the reference's ``data`` axis of language-model
training (``models/api.make_train_step(cfg, data=)``, ``launch/train``):
each rank holds an equal share of the batch and ``ClientMesh.mean_`` takes
the f32 mean of a gradient over the group.  :class:`PodDataMesh` is the
reference's ``("pod", "data")`` mesh of the pod step (``core/mesh_fl``):
rank ``p * D + r`` is data rank r of pod p, with one ``ClientMesh`` a
axis (:func:`pod_data_mesh`).

Beside it, the reference's logical-axis rules (MaxText style, with a
divisibility fallback) for the language models.  Each family exposes an
``axes(cfg)`` tree whose leaves are tuples of logical dimension names
(``None`` for an absent leaf); :func:`resolve_spec` maps one onto a mesh:

  model axis  <- first divisible logical dim in MODEL_PRIORITY
  data axis   <- "batch" when divisible (jointly with "pod" on multi-pod
                 meshes), else "embed" (FSDP), else "cache_seq"
  pod axis    <- only ever combined with "batch": parameters stay
                 replicated across pods

A dim never gets an axis it is not divisible by, and a mesh axis is used
at most once per tensor.  A spec is a plain tuple, one entry per dim
(``None``, ``"model"``, ``"data"`` or ``("pod", "data")``): it compares
equal to the reference's ``PartitionSpec``.  :func:`to_placements` turns
one into DTensor placements over a ``DeviceMesh``; :func:`use_mesh`
installs the ambient mesh that ``models/layers.shard_hint`` reads.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Iterator

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

    def mean_(self, t: torch.Tensor) -> torch.Tensor:
        """The f32 mean of ``t`` over the group: summed in f32 by
        :meth:`sum_`, then divided by the group's size.  An f32 ``t`` is
        reduced in place and returned; any other dtype gives a new f32
        tensor (a bf16 gradient is never summed in bf16)."""
        buf = self.sum_(t.to(torch.float32))
        return buf.div_(self.size)

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


@dataclasses.dataclass(frozen=True)
class PodDataMesh:
    """The reference's ``("pod", "data")`` mesh over process groups: rank
    ``p * D + r`` is data rank r of pod p.  ``data`` is pod p's group,
    ranks {p D, ..., p D + D - 1} (the cheap in-pod hop: a gradient's
    mean); ``pod`` is data index r's group, ranks {r, D + r, 2 D + r, ...}
    (the pods' exchange).  Each is a :class:`ClientMesh` of this rank."""

    pod: ClientMesh
    data: ClientMesh

    @property
    def axis_names(self) -> tuple[str, str]:
        return ("pod", "data")

    @property
    def shape(self) -> dict[str, int]:
        return {"pod": self.pod.size, "data": self.data.size}


def pod_data_mesh(n_data: int) -> PodDataMesh:
    """The :class:`PodDataMesh` of ``n_data`` data ranks a pod over every
    rank of the default group (W = P ``n_data`` ranks, P pods).  Every
    rank calls ``dist.new_group`` for every subgroup, in the same order
    (the data groups, then the pod groups), as ``torch.distributed``
    requires; an axis that spans every rank is the default group itself.
    ``n_data=1`` gives the one-axis pod mesh, pod r on rank r."""
    world = client_mesh()
    if n_data < 1 or world.size % n_data:
        raise ValueError(f"{n_data} data ranks a pod do not divide the {world.size} ranks")
    n_pods = world.size // n_data

    def groups(members: list[list[int]]) -> Any:
        made = [None if len(m) == world.size else dist.new_group(m) for m in members]
        return next(g for g, m in zip(made, members) if world.rank in m)

    data = groups([list(range(p * n_data, (p + 1) * n_data)) for p in range(n_pods)])
    pod = groups([list(range(r, world.size, n_data)) for r in range(n_data)])
    return PodDataMesh(pod=ClientMesh(pod, world.rank // n_data, n_pods),
                       data=ClientMesh(data, world.rank % n_data, n_data))


# Order matters: prefer the big compute dims, fall back to head_dim.
# "seq_shard" is an activation-only logical name (sequence-parallel
# attention for indivisible head counts; ``layers.shard_hint`` callers).
MODEL_PRIORITY = (
    "ff",
    "vocab",
    "heads",
    "kv_heads",
    "inner",
    "inner_proj",
    "inner_conv",
    "ssm_heads",
    "experts",
    "head_dim",
    "seq_shard",
)

DATA_PRIORITY = ("batch", "embed", "cache_seq", "tokens")


def resolve_spec(logical: tuple[str | None, ...] | None, shape: tuple[int, ...],
                 mesh: Any) -> tuple:
    """One leaf's logical axes -> its spec on ``mesh`` (anything with
    ``.shape``, a dict of axis sizes, and ``.axis_names``; ``launch/mesh``'s
    ``AbstractMesh``).  ``None`` (a replicated leaf) gives ``()``."""
    if logical is None:
        return ()
    if len(logical) != len(shape):
        raise ValueError(f"logical axes {logical} do not match the shape {tuple(shape)}")
    assignment: list[Any] = [None] * len(shape)
    has_pod = "pod" in mesh.axis_names
    model_n = mesh.shape["model"]
    data_n = mesh.shape["data"]
    pod_n = mesh.shape["pod"] if has_pod else 1

    for name in MODEL_PRIORITY:
        i = next((i for i, ax in enumerate(logical)
                  if ax == name and shape[i] % model_n == 0 and shape[i] > 0), None)
        if i is not None:
            assignment[i] = "model"
            break

    placed = False
    for name in DATA_PRIORITY:
        for i, ax in enumerate(logical):
            if ax != name or assignment[i] is not None or shape[i] == 0:
                continue
            if name == "batch" and has_pod and shape[i] % (pod_n * data_n) == 0:
                assignment[i] = ("pod", "data")
                placed = True
            elif shape[i] % data_n == 0:
                assignment[i] = "data"
                placed = True
            if placed:
                break
        if placed:
            break
    return tuple(assignment)


def is_axes_leaf(x: Any) -> bool:
    """A logical-axes tuple: a plain tuple of names and ``None``s.  A
    NamedTuple (a block of axes) is a node, whatever its fields hold."""
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(isinstance(e, (str, type(None))) for e in x))


def map_axes(fn, abstract: Any, axes_tree: Any) -> Any:
    """``fn(leaf, logical)`` over the tensor leaves of ``abstract`` (a tree
    of NamedTuples, tuples and ``None``s) paired with the logical tuples of
    ``axes_tree``, as a tree of ``abstract``'s structure.  A ``None``
    param pairs with ``None`` axes and stays ``None``; any other mismatch
    raises ``ValueError``."""
    if abstract is None:
        if axes_tree is not None:
            raise ValueError(f"axes {axes_tree} for an absent leaf")
        return None
    if isinstance(abstract, torch.Tensor):
        if not is_axes_leaf(axes_tree):
            raise ValueError(f"a tensor of shape {tuple(abstract.shape)} paired with "
                             f"{axes_tree!r}, not a logical-axes tuple")
        return fn(abstract, axes_tree)
    if isinstance(abstract, tuple):
        if (not isinstance(axes_tree, tuple) or is_axes_leaf(axes_tree)
                or len(axes_tree) != len(abstract)):
            raise ValueError(f"axes tree mismatch: {type(abstract).__name__} of "
                             f"{len(abstract)} paired with {axes_tree!r}")
        items = [map_axes(fn, a, x) for a, x in zip(abstract, axes_tree)]
        return type(abstract)(*items) if hasattr(abstract, "_fields") else tuple(items)
    raise TypeError(f"unexpected node {type(abstract).__name__} in a param tree")


def tree_shardings(abstract: Any, axes_tree: Any, mesh: Any) -> Any:
    """The spec of every leaf of ``abstract`` (tensors, meta tensors
    included) on ``mesh``, as a tree of ``abstract``'s structure whose
    leaves are spec tuples."""
    return map_axes(lambda leaf, logical: resolve_spec(logical, tuple(leaf.shape), mesh),
                    abstract, axes_tree)


def batch_shardings(specs: dict[str, torch.Tensor], mesh: Any) -> dict[str, tuple]:
    """Input batches: the leading (batch) dim over (pod, data)."""
    return {k: resolve_spec(("batch",) + (None,) * (v.dim() - 1), tuple(v.shape), mesh)
            for k, v in specs.items()}


def spec_devices(spec: tuple, mesh: Any) -> int:
    """How many ways ``spec`` splits a leaf: the product of the sizes of
    the mesh axes it names."""
    n = 1
    for entry in spec:
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                n *= mesh.shape[name]
    return n


def to_placements(spec: tuple, device_mesh: Any) -> tuple:
    """``spec`` as DTensor placements over ``device_mesh`` (its
    ``mesh_dim_names``): ``Shard(i)`` on each mesh dim that tensor dim
    ``i`` names (both "pod" and "data" for a joint batch dim, pod the
    major), ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    names = device_mesh.mesh_dim_names
    out = []
    for name in names:
        dims = [i for i, entry in enumerate(spec)
                if entry == name or (isinstance(entry, tuple) and name in entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    unknown = {n for e in spec for n in (e if isinstance(e, tuple) else (e,))
               if n is not None and n not in names}
    if unknown:
        raise ValueError(f"spec {spec} names mesh axes {sorted(unknown)} that {names} lacks")
    return tuple(out)


@dataclasses.dataclass
class MeshScope:
    """The ambient mesh installed by :func:`use_mesh`, and the activation
    hints resolved against it (``models/layers.shard_hint``)."""

    mesh: Any
    hints: int = 0


_AMBIENT: contextvars.ContextVar[MeshScope | None] = contextvars.ContextVar(
    "repro_torch_ambient_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Any) -> Iterator[MeshScope]:
    """Install ``mesh`` as the ambient mesh for the block (what the
    reference's ``jax.sharding.set_mesh`` does for its dry run)."""
    scope = MeshScope(mesh)
    token = _AMBIENT.set(scope)
    try:
        yield scope
    finally:
        _AMBIENT.reset(token)


def ambient() -> MeshScope | None:
    """The :class:`MeshScope` of the innermost :func:`use_mesh`, or None."""
    return _AMBIENT.get()

"""Production meshes and the H100's roofline constants, the port of
``repro.launch.mesh``.

A mesh here is a named shape, :class:`AbstractMesh`: all that the
logical-axis rules (``launch/sharding.resolve_spec``), the dry run and the
roofline read.  Making one touches no device and no process group, so the
dry run plans a 16 x 16 (or 2 x 16 x 16) mesh on a machine without a card.
:func:`device_mesh` turns one into a ``torch.distributed`` ``DeviceMesh``
when a process group of that size exists.

The reference's ``shard_map_compat`` (a shim over two JAX versions'
``shard_map``) has no PyTorch counterpart and is not ported.
"""
from __future__ import annotations

import dataclasses
import math

import torch.distributed as dist

# One NVIDIA H100 SXM5 (NVIDIA, "H100 Tensor Core GPU" datasheet, the SXM
# column; rates at the 700 W power limit).
PEAK_FLOPS_BF16 = 989.4e12   # dense bf16 tensor-core FLOP/s (1,979e12 is with sparsity)
PEAK_FLOPS_F32 = 67e12       # f32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12             # HBM3 bytes/s
NVLINK_BW = 450e9            # NVLink 4 bytes/s a direction (900e9 counts both)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh as a named shape: ``axis_names`` and their sizes."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for {len(self.sizes)} sizes")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis in {self.axis_names}")
        if any(n < 1 for n in self.sizes):
            raise ValueError(f"mesh axis sizes must be positive, got {self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The number of devices."""
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16 x 16 = 256 devices over ("data", "model"); multi-pod 2 x 16 x 16
    with "pod" in front."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def make_host_mesh() -> AbstractMesh:
    """One device with the production axis names."""
    return AbstractMesh(("data", "model"), (1, 1))


def make_federated_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The hierarchical-FL runtime's mesh: ``data`` carries the federated
    clients, pods play the fog clusters; the production mesh's shape."""
    return make_production_mesh(multi_pod=multi_pod)


def device_mesh(mesh: AbstractMesh):
    """``mesh`` as a ``torch.distributed.device_mesh.DeviceMesh`` of CUDA
    devices over the default process group, one rank a card; raises ``RuntimeError``
    unless an initialised group has exactly ``mesh.size`` ranks."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"device_mesh needs an initialised process group of {mesh.size} "
                           "ranks (torch.distributed.init_process_group, or torchrun)")
    world = dist.get_world_size()
    if world != mesh.size:
        raise RuntimeError(f"the process group has {world} ranks, the mesh {mesh.shape} "
                           f"needs {mesh.size}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cuda", mesh.sizes, mesh_dim_names=mesh.axis_names)

"""Production and host meshes (the port of ``repro.launch.mesh``).

Each returns a ``DeviceMesh`` over the current process group when one is
initialized with exactly as many ranks as the mesh has, else the mesh's
abstract shape (:class:`repro_torch.sharding.rules.MeshShape`), which
the dry run places on.  Neither touches a device: a ``DeviceMesh`` only
names the ranks.
"""

from __future__ import annotations

import math

from repro_torch.sharding.rules import MeshShape


def device_type() -> str:
    """The device a process group's ranks compute on: "cuda" under NCCL,
    "cpu" under gloo."""
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def build_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` over the process group's ranks in
    order when its world size is the mesh's size; else the abstract
    :class:`MeshShape`."""
    import torch.distributed as dist
    shape, axes = tuple(shape), tuple(axes)
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() == math.prod(shape):
        from torch.distributed.device_mesh import init_device_mesh
        return init_device_mesh(device_type(), shape, mesh_dim_names=axes)
    return MeshShape(axes, shape)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return build_mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1):
    """A small ("data", "model") mesh (the CPU tests' gloo ranks, or one
    card)."""
    return build_mesh((data, model), ("data", "model"))

"""Elastic scaling: rebuild the mesh from the surviving ranks and
reshard a state onto it (the port of ``repro.runtime.elastic``).

The recovery path:
  1. detect the healthy rank set,
  2. choose the largest (data, model) factorization that preserves the
     model-parallel degree (:func:`choose_mesh_shape`),
  3. reshard the state (:func:`reshard_state`; a checkpoint restored
     with the new mesh's specs is the same thing,
     ``Checkpointer.restore(like, shardings=..., mesh=...)``).
"""

from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.sharding import rules as R
from repro_torch.tree import tree_map


def choose_mesh_shape(n_devices: int, model_parallel: int,
                      pod_size: Optional[int] = None):
    """Largest usable (pod, data, model) given surviving devices."""
    if n_devices < model_parallel:
        raise ValueError("fewer devices than the model-parallel degree")
    usable_dp = n_devices // model_parallel
    if pod_size and pod_size // model_parallel > 0:
        dp_per_pod = pod_size // model_parallel
        pods = max(1, usable_dp // dp_per_pod)
        if pods > 1:
            return (pods, dp_per_pod, model_parallel)
    return (usable_dp, model_parallel)


def make_elastic_mesh(model_parallel: int,
                      devices: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` over the surviving ranks ``devices`` of the
    process group (all of them by default), shaped by
    :func:`choose_mesh_shape`; ranks past the used count are left out.
    Every rank of the group calls it (the mesh's subgroups are made
    collectively)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import device_type
    ranks = list(devices if devices is not None
                 else range(dist.get_world_size()))
    shape = choose_mesh_shape(len(ranks), model_parallel)
    used = 1
    for s in shape:
        used *= s
    axes = (("pod", "data", "model") if len(shape) == 3
            else ("data", "model"))
    grid = torch.tensor(ranks[:used], dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type(), grid, mesh_dim_names=axes)


def reshard_state(state, new_mesh):
    """A live state (DTensor leaves on any mesh, or full tensors)
    redistributed onto ``new_mesh``'s placements (the rules' specs, as
    :func:`repro_torch.sharding.rules.place_state` holds them): each
    leaf gathered where it lies, then cut to this rank's shard.  Every
    rank of both meshes calls it."""
    dev = R.mesh_device(new_mesh)
    return R.place_state(tree_map(lambda t: R.full_tensor(t).to(dev),
                                  state), new_mesh)

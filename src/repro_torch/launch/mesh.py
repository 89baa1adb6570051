"""Device meshes over the ranks of a ``torch.distributed`` process group
(counterpart of ``repro/launch/mesh.py``).

``make_production_mesh`` is a function, so importing this module
touches no process group: only a caller that has set up a group (a real
one, or a fake one for a dry run) builds the (16, 16) or (2, 16, 16)
mesh. Both meshes follow the port's device rule: they lie on the card
unless the caller passes ``device_type="cpu"``, and raise without a
card; the backend does not choose (Gloo carries CUDA tensors too).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import device as devmod


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = devmod.DEFAULT):
    """The production mesh: (data 16, model 16), or (pod 2, data 16,
    model 16) with ``multi_pod``, over the current group's ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(devmod.resolve(device_type).type, shape,
                            mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: str = devmod.DEFAULT):
    """A (data, model) mesh over every rank of the current process group.
    Raises unless ``data * model`` is the group's world size. On the card
    each rank takes card ``rank % device_count``."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = devmod.resolve(device_type).type
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialized process "
                           "group (torchrun, or init_process_group)")
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"mesh data={data} x model={model} = {data * model} "
                         f"does not match the world size {world}")
    if dev == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev, (data, model),
                            mesh_dim_names=("data", "model"))

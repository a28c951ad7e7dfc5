"""Production mesh builder.

Port of ``repro/launch/mesh.py``. FUNCTIONS, not module-level constants:
importing this module touches no process group, so a one-rank test and a
dry run of 512 ranks import it alike.

  single pod : (data=16, model=16)            = 256 ranks
  multi-pod  : (pod=2, data=16, model=16)     = 512 ranks

The 'model' axis is innermost, so TP/EP collectives stay among
neighbouring ranks; the 'pod' axis carries only the data-parallel
gradient reduction (optionally int8-compressed,
``distributed/compress.py``).

``make_production_mesh`` is a ``DeviceMesh`` when a world of that size
is up (``torchrun`` started it), else a ``LogicalMesh`` of the same shape
and axis names, which the dry run places meta tensors on.
``make_host_mesh`` is a ``DeviceMesh`` over the current world.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import LogicalMesh


def production_shape(multi_pod: bool = False) -> tuple[tuple, tuple]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _device_type() -> str:
    """The ranks' device type: the process group's backend decides."""
    backend = str(dist.get_backend()).lower()
    return "cuda" if "nccl" in backend or (
        "cuda:" in backend and torch.cuda.is_available()) else "cpu"


def make_host_mesh(shape=(2, 2), axes=("data", "model"), *,
                   device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` over the current world, which must
    have exactly that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_host_mesh needs torch.distributed "
                           "initialized (torchrun, or init_process_group)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a mesh of shape {tuple(shape)} needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    shape, axes = production_shape(multi_pod)
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() == math.prod(shape):
        return make_host_mesh(shape, axes, device_type=device_type)
    return LogicalMesh(shape, axes)

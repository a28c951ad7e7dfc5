"""Ambient mesh context: lets model code (the sharded MoE and block)
find the mesh the launcher built without threading it through every
config.

Port of ``repro/distributed/context.py``. The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` (``launch/mesh.py``);
``mesh_context`` sets it for the body of a ``with`` and restores the one
before. Setting a mesh starts no process group: that is the caller's.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Optional

_MESH: Optional[Any] = None


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


@contextmanager
def mesh_context(mesh):
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)

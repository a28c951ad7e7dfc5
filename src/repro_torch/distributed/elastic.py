"""Elastic rescaling: resume a checkpoint on a different mesh.

Port of ``repro/distributed/elastic.py``. Losing a pod mid-run must not
lose the run. The recovery path:

  1. the loop's CheckpointManager has a committed TrainState on stable
     storage, saved as logical (full) arrays;
  2. ``rescale()`` takes the new mesh over the surviving ranks, recomputes
     the sharding rules for it (pure functions of path, shape, config and
     mesh, so any divisor-compatible mesh works) and places each leaf by
     its new sharding;
  3. the caller resumes at the checkpointed step with the same train step
     (the data pipeline is step-indexed).

The same path handles scale-up. The ranks are the caller's: a new world
of the surviving ranks (``torchrun``, or ``init_process_group``), or a
sub-mesh of the running world, as the reference's test restores onto
some of its devices.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.step import TrainState, train_state_shardings


def make_mesh_from_devices(devices, shape, axis_names, *,
                           device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the first prod(shape) of
    ``devices`` (global ranks of the current world), ``axis_names`` as
    its dim names. Every rank of the world calls it; a rank outside the
    mesh gets no coordinate (``get_coordinate() is None``) and sits the
    mesh's work out."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = np.asarray(list(devices)[:math.prod(shape)]).reshape(shape)
    return DeviceMesh(device_type, ranks.tolist(),
                      mesh_dim_names=tuple(axis_names))


def rescale(ckpt: CheckpointManager, state_like: TrainState, cfg,
            new_mesh, *, step: int | None = None):
    """Restore the latest (or ``step``'s) committed TrainState onto
    ``new_mesh``. ``state_like``: a full state of the right structure,
    shapes and dtypes on this rank's device (``init_train_state``'s),
    filled in place and then placed. Returns (state, shardings, step)."""
    shardings = train_state_shardings(state_like, cfg, new_mesh)
    state, at_step = ckpt.restore(state_like, step=step,
                                  shardings=shardings)
    return state, shardings, at_step

"""Carrying state across from the JAX package, through numpy.

The port never imports JAX; a caller that holds the reference's arrays
(a test, a migration script) turns them into numpy first and hands them
here. Every function places its result on ``device`` (default: the card).

  topology_from_numpy  a padded-CSR neighbor table -> ``Topology``
  state_from_numpy     a model state dict -> tensors (and back with
                       ``state_to_numpy``)
  key_from_data        ``jax.random.key_data`` output (uint32 [..., 2]) ->
                       a port key (int64 [..., 2])
  recipes_from_numpy   a window of recipes made by the reference -> port
                       recipes; uint32 leaves are key data (SIS's per-task
                       keys) and become port keys. Injecting these lets a
                       test tell a PRNG fault from a schedule fault.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.topology import Topology
from repro_torch.utils.device import resolve_device


def topology_from_numpy(neighbors, degrees, device=None) -> Topology:
    dev = resolve_device(device)
    return Topology(
        neighbors=torch.tensor(np.asarray(neighbors, np.int32), device=dev),
        degrees=torch.tensor(np.asarray(degrees, np.int32), device=dev))


def key_from_data(data, device=None) -> torch.Tensor:
    data = np.asarray(data)
    if data.dtype != np.uint32 or data.shape[-1:] != (2,):
        raise ValueError(f"key data must be uint32 [..., 2], got "
                         f"{data.dtype} {data.shape}")
    return torch.tensor(data.astype(np.int64), device=resolve_device(device))


def _leaf(x, dev) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype == np.uint32:
        return key_from_data(x, dev)
    return torch.tensor(x, device=dev)


def state_from_numpy(state: dict, device=None) -> dict:
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v), device=dev)
            for k, v in state.items()}


def state_to_numpy(state: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def recipes_from_numpy(recipes: dict, device=None) -> dict:
    dev = resolve_device(device)
    return {k: _leaf(v, dev) for k, v in recipes.items()}

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
  lm_params_from_numpy the reference's LM parameter pytree (``Model.init``
                       output as numpy) -> the port's ``LMParams`` module
                       tree, stacked ``[L, ...]`` segment leaves unstacked
                       per layer
  lm_states_from_numpy the reference's serving states (``segs`` of KV
                       caches with ``k``, ``v``, ``length``, ``kpos``, or
                       of RWKV states ``tm.last``, ``tm.s``, ``cm.last``;
                       and ``pos``) -> the port's (and back with
                       ``lm_states_to_numpy``)
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


# ---------------------------------------------------------------- the LM
#: numpy dtypes without a torch counterpart, carried by their bits
_BITS = {"bfloat16": (np.uint16, torch.bfloat16),
         "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def _tensor(x, dev) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name in _BITS:
        bits, dtype = _BITS[x.dtype.name]
        return torch.from_numpy(
            np.ascontiguousarray(x).view(bits).copy()).view(dtype).to(dev)
    return torch.tensor(x, device=dev)


def _flat(tree, prefix: str = ""):
    """(dotted path, leaf) pairs of a nested dict/list pytree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def lm_params_from_numpy(model, tree: dict):
    """The reference's parameter pytree (numpy leaves) as the port's
    ``LMParams`` on the model's device. Segment leaves are stacked
    ``[L, ...]`` in the reference and one module per layer here
    (``segments.<i>.<layer>.<path>``). Every parameter must be matched
    by exactly one leaf of the same shape."""
    leaves = {}
    for path, x in _flat(tree):
        parts = path.split(".")
        if parts[0] == "segments":
            x = np.asarray(x)
            for layer in range(x.shape[0]):
                name = ".".join(parts[:2] + [str(layer)] + parts[2:])
                leaves[name] = x[layer]
        else:
            leaves[path] = x
    params = model.empty_params()
    names = dict(params.named_parameters())
    if set(names) != set(leaves):
        raise ValueError(
            f"parameter trees differ: only in the port "
            f"{sorted(set(names) - set(leaves))[:5]}, only in the "
            f"reference {sorted(set(leaves) - set(names))[:5]}")
    with torch.no_grad():
        for name, p in names.items():
            x = _tensor(leaves[name], p.device)
            if x.shape != p.shape or x.dtype != p.dtype:
                raise ValueError(f"{name}: reference {x.dtype} "
                                 f"{tuple(x.shape)}, port {p.dtype} "
                                 f"{tuple(p.shape)}")
            p.copy_(x)
    return params


_KV = ("k", "v", "length", "kpos")


def _kv_leaf(cache, name):
    return cache[name] if isinstance(cache, dict) else getattr(cache, name)


def _is_kv(x) -> bool:
    """A KV cache of either side: a dict or NamedTuple of ``_KV``."""
    names = x.keys() if isinstance(x, dict) else getattr(x, "_fields", ())
    return set(names) == set(_KV)


def lm_states_from_numpy(states: dict, device=None) -> dict:
    """Serving states of the reference (``segs``: per segment a tree of
    stacked leaves — ``{"kv": KVCache}``, or the RWKV ``{"tm": {"last",
    "s"}, "cm": {"last"}}``; ``pos``), numpy leaves, as the port's states
    on ``device``."""
    from repro_torch.models.attention import KVCache, map_state

    dev = resolve_device(device)

    def leaf(x):
        if _is_kv(x):
            return KVCache(*(_tensor(_kv_leaf(x, n), dev) for n in _KV))
        return _tensor(x, dev)

    return {"segs": [map_state(leaf, s, is_leaf=_is_kv)
                     for s in states["segs"]],
            "pos": _tensor(states["pos"], dev)}


def lm_states_to_numpy(states: dict) -> dict:
    """A numpy copy of the port's serving states: ``segs`` of
    ``{"kv": {"k", "v", "length", "kpos"}}`` or ``{"tm": {"last", "s"},
    "cm": {"last"}}`` (float leaves as float32) and ``pos``."""
    from repro_torch.models.attention import KVCache, map_state

    def arr(t):  # a copy: the port updates its states in place
        t = t.detach().float() if t.is_floating_point() else t.detach()
        return np.array(t.cpu().numpy())

    def leaf(x):
        if isinstance(x, KVCache):
            return {n: arr(getattr(x, n)) for n in _KV}
        return arr(x)

    return {"segs": map_state(leaf, list(states["segs"]),
                              is_leaf=lambda x: isinstance(x, KVCache)),
            "pos": arr(states["pos"])}

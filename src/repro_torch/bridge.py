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
                       caches with ``k``, ``v``, ``length``, ``kpos``, of
                       hymba's ``{"kv", "ssm"}``, or of RWKV states
                       ``tm.last``, ``tm.s``, ``cm.last``; ``pos``, and
                       the encoder-decoder's ``enc_out``) -> the port's
                       (and back with ``lm_states_to_numpy``)
  lm_params_to_numpy   the port's ``LMParams`` — or a dict of gradients
                       keyed by the parameters' names — -> the reference's
                       parameter pytree, segment leaves stacked
  train_state_from_numpy the reference's ``TrainState`` (params, AdamW
                       ``mu``/``nu``/``count``, ``step``; NamedTuples or
                       dicts of numpy leaves) -> the port's, on the
                       model's device, parameters requiring grad (and back
                       with ``train_state_to_numpy``, as nested dicts)

Placed states (DTensors on a mesh, ``distributed/sharding.py``): going to
numpy a DTensor leaf is gathered into its logical array first (a
collective: every rank calls), so the reference's layout comes out
whatever the placement; coming back, ``train_state_from_numpy``'s
``shardings=`` (``train_state_shardings``) places the state on its mesh.

Going to numpy, bfloat16 leaves come out as float32 (exact; numpy has no
bfloat16 without ml_dtypes). Checkpoints keep bf16 bits
(``train/checkpoint.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.spmd import full_tensor
from repro_torch.topology import Topology
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import load_leaves, stack_leaves


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
    """(dotted path, leaf) pairs of a nested dict/list/NamedTuple
    pytree."""
    if hasattr(tree, "_fields"):                    # a NamedTuple
        for k in tree._fields:
            yield from _flat(getattr(tree, k), f"{prefix}{k}.")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _load(target, tree) -> None:
    """Copy a reference pytree (numpy leaves) into the port tree
    ``target`` leaf by leaf, through the reference's paths
    (``utils/pytree.load_leaves``): a stacked ``[L, ...]`` segment leaf
    fills the segment's layers in order. Every leaf must be matched by
    exactly one of the same shape and dtype."""
    flat = {path.replace(".", "/"): x for path, x in _flat(tree)}
    load_leaves(target, flat, lambda path: _tensor(flat[path], "cpu"))


def lm_params_from_numpy(model, tree: dict):
    """The reference's parameter pytree (numpy leaves) as the port's
    ``LMParams`` on the model's device. Segment leaves are stacked
    ``[L, ...]`` in the reference and one module per layer here
    (``segments.<i>.<layer>.<path>``). Every parameter must be matched
    by exactly one leaf of the same shape."""
    params = model.empty_params()
    _load(params, tree)
    return params


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of the logical tensor; float leaves as float32."""
    t = full_tensor(t)
    t = t.detach().float() if t.is_floating_point() else t.detach()
    return np.array(t.cpu().numpy())


def _nest(flat: dict) -> dict:
    """``/``-joined paths -> nested dicts; a dict whose keys are all
    indices (``segments``) becomes a list."""
    root: dict = {}
    for path, x in flat.items():
        *parents, last = path.split("/")
        node = root
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = x

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def _to_reference(tree) -> dict:
    return _nest(stack_leaves(tree, _numpy))


def lm_params_to_numpy(params) -> dict:
    """The reference's parameter pytree (nested dicts and the
    ``segments`` list, numpy leaves, segment leaves stacked ``[L, ...]``)
    of the port's ``LMParams``, or of a dict of tensors keyed by the
    parameters' names (gradients, an AdamW moment)."""
    return _to_reference(params)


def train_state_to_numpy(state) -> dict:
    """The reference's ``TrainState`` layout as nested dicts: ``params``,
    ``opt`` (``mu``, ``nu``, ``count``) and ``step``, numpy leaves."""
    return _to_reference(state)


def train_state_from_numpy(model, tree, *, shardings=None):
    """The reference's ``TrainState`` (NamedTuples or dicts: ``params``,
    ``opt`` with ``mu``, ``nu``, ``count``, and ``step``; numpy leaves)
    as the port's, on the model's device; the parameters require grad.
    ``shardings`` (``train_state_shardings``): placed on its mesh."""
    from repro_torch.train.optim import adamw_init
    from repro_torch.train.step import TrainState

    params = model.empty_params()
    state = TrainState(params, adamw_init(params),
                       torch.zeros((), dtype=torch.int32, device=model.device))
    _load(state, tree)
    params.requires_grad_(True)
    if shardings is not None:
        from repro_torch.train.step import place_train_state

        state = place_train_state(state, shardings)
    return state


_KV = ("k", "v", "length", "kpos")


def _kv_leaf(cache, name):
    return cache[name] if isinstance(cache, dict) else getattr(cache, name)


def _is_kv(x) -> bool:
    """A KV cache of either side: a dict or NamedTuple of ``_KV``."""
    names = x.keys() if isinstance(x, dict) else getattr(x, "_fields", ())
    return set(names) == set(_KV)


def lm_states_from_numpy(states: dict, device=None) -> dict:
    """Serving states of the reference (``segs``: per segment a tree of
    stacked leaves — ``{"kv": KVCache}``, hymba's ``{"kv": KVCache,
    "ssm"}``, or the RWKV ``{"tm": {"last", "s"}, "cm": {"last"}}``;
    ``pos``; ``enc_out``), numpy leaves, as the port's states on
    ``device``."""
    from repro_torch.models.attention import KVCache, map_state

    dev = resolve_device(device)

    def leaf(x):
        if _is_kv(x):
            return KVCache(*(_tensor(_kv_leaf(x, n), dev) for n in _KV))
        return _tensor(x, dev)

    out = {k: _tensor(v, dev) for k, v in states.items() if k != "segs"}
    return {"segs": [map_state(leaf, s, is_leaf=_is_kv)
                     for s in states["segs"]], **out}


def lm_states_to_numpy(states: dict) -> dict:
    """A numpy copy of the port's serving states: ``segs`` of
    ``{"kv": {"k", "v", "length", "kpos"}}`` (with hymba's ``ssm``) or
    ``{"tm": {"last", "s"}, "cm": {"last"}}`` (float leaves as float32),
    ``pos`` and, for the encoder-decoder, ``enc_out``."""
    from repro_torch.models.attention import KVCache, map_state

    def leaf(x):  # copies: the port updates its states in place
        if isinstance(x, KVCache):
            return {n: _numpy(getattr(x, n)) for n in _KV}
        return _numpy(x)

    out = {k: _numpy(v) for k, v in states.items() if k != "segs"}
    return {"segs": map_state(leaf, list(states["segs"]),
                              is_leaf=lambda x: isinstance(x, KVCache)),
            **out}

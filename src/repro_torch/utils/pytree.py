"""Leaf paths of the port's trees in the reference's layout.

Port of what the training path needs from ``repro/utils/pytree.py``: the
reference's ``/``-joined leaf paths (the keys of its checkpoints), the
one walk between a port tree and the reference's stacked host leaves in
each direction (``stack_leaves``, ``load_leaves``: the bridge and the
checkpoint differ only in how a leaf is converted), and the parameter
and byte counts of a tree.

A port tree is made of ``NamedTuple``s, dicts, lists, ``nn.Module``s
(their parameters, by ``named_parameters``) and tensors. Its leaf names
join the keys with ``.``: ``params.segments.0.3.attn.wq.w``,
``opt.mu.segments.0.3.attn.wq.w`` (a dict keyed by the parameters' own
names), ``opt.count``, ``step``. The reference stacks every segment's
layers into one leaf ``[L, ...]``, so a port leaf
``<...>.segments.<i>.<layer>.<rest>`` is row ``layer`` of the reference
leaf ``<...>/segments/<i>/<rest>`` (and likewise under the encoder's
``enc_segments``).
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch
from torch import nn


def named_leaves(tree: Any, prefix: str = "") -> Iterator[
        tuple[str, torch.Tensor]]:
    """(``.``-joined name, tensor) of every leaf of a port tree."""
    if isinstance(tree, torch.Tensor):
        yield prefix[:-1], tree
    elif isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield prefix + name, p
    elif hasattr(tree, "_fields"):                  # a NamedTuple
        for name in tree._fields:
            yield from named_leaves(getattr(tree, name), f"{prefix}{name}.")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}.")
    elif tree is not None:
        raise TypeError(f"{prefix[:-1]}: not a tree node: {type(tree)}")


#: the stacked lists of segments: the decoder's and the encoder's
STACKED = ("segments", "enc_segments")


def reference_path(name: str) -> tuple[str, int | None]:
    """A port leaf name -> (the reference's ``/``-joined path, the row of
    its stacked ``[L, ...]`` leaf, or None outside the segments)."""
    parts = name.split(".")
    at = next((i for i, p in enumerate(parts) if p in STACKED), None)
    if at is None:
        return "/".join(parts), None
    at += 2
    return "/".join(parts[:at] + parts[at + 1:]), int(parts[at])


def reference_ndim(name: str, t: torch.Tensor) -> int:
    """The rank the leaf has in the reference's stacked tree."""
    return t.ndim + (reference_path(name)[1] is not None)


def reference_leaves(tree: Any) -> dict[
        str, torch.Tensor | list[torch.Tensor]]:
    """The reference's leaves of a port tree, in the tree's order: path ->
    the port tensor, or for a segment leaf the list of its layers' tensors
    (row i of the stacked leaf is the list's item i)."""
    rows: dict[str, dict[int, torch.Tensor]] = {}
    out: dict[str, torch.Tensor | list[torch.Tensor]] = {}
    for name, t in named_leaves(tree):
        path, layer = reference_path(name)
        if layer is None:
            out[path] = t
        else:
            rows.setdefault(path, {})[layer] = t
            out[path] = []                  # keeps the tree's leaf order
    for path, by_layer in rows.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"{path}: layers {sorted(by_layer)}")
        out[path] = [by_layer[i] for i in range(len(by_layer))]
    return out


def stack_leaves(tree: Any, convert: Callable[[torch.Tensor], np.ndarray]
                 ) -> dict[str, np.ndarray]:
    """The reference's leaves of a port tree on the host: path ->
    ``convert`` of the tensor, a segment's layers stacked ``[L, ...]``."""
    return {p: np.stack([convert(t) for t in x]) if isinstance(x, list)
            else convert(x) for p, x in reference_leaves(tree).items()}


@torch.no_grad()
def load_leaves(tree: Any, paths: Iterable[str],
                read: Callable[[str], torch.Tensor],
                write: Callable[[torch.Tensor, torch.Tensor], Any] = None
                ) -> None:
    """Fill the tensors of the port tree ``tree`` in place from the
    reference's leaves: ``paths`` are the leaves on offer and ``read(path)``
    gives one as a tensor, a segment's layers stacked ``[L, ...]`` (row i
    fills layer i). Both sides must hold the same paths, and every tensor
    read the shape and dtype of the one it fills. ``write(dst, x)`` stores
    one (default ``dst.copy_(x)``)."""
    write = write or (lambda dst, x: dst.copy_(x))
    want = reference_leaves(tree)
    paths = set(paths)
    if paths != set(want):
        raise ValueError(
            f"trees differ: only in the port "
            f"{sorted(set(want) - paths)[:5]}, only in the "
            f"reference {sorted(paths - set(want))[:5]}")
    for path, leaf in want.items():
        src = read(path)
        if isinstance(leaf, list):
            if len(src) != len(leaf):
                raise ValueError(f"{path}: reference {len(src)} layers, "
                                 f"port {len(leaf)}")
            pairs = [(f"{path}[{i}]", dst, src[i])
                     for i, dst in enumerate(leaf)]
        else:
            pairs = [(path, leaf, src)]
        for name, dst, x in pairs:
            if x.shape != dst.shape or x.dtype != dst.dtype:
                raise ValueError(
                    f"{name}: reference {x.dtype} of shape "
                    f"{tuple(x.shape)}, port {dst.dtype} of shape "
                    f"{tuple(dst.shape)}")
            write(dst, x)


def tree_map_with_path_str(fn: Callable[[str, Any], Any], tree: Any, *,
                           stacked: bool = False) -> dict[str, Any]:
    """{port leaf name: ``fn(path, leaf)``} over a port tree, ``path`` the
    reference's ``/``-joined path of the leaf (``reference_path``): the
    reference's ``tree_map_with_path_str``, for the logical-axis sharding
    rules to match parameter names.

    The port's per-layer leaves lack the reference's stacked layer axis.
    The rules index from the end, so most see no difference; but ZeRO-1
    may pick the layer axis itself. With ``stacked=True`` a layer's leaf
    reaches ``fn`` as a meta tensor of the reference's stacked shape
    ``[L, ...]`` (one call per stacked leaf, its result shared by the
    layers), so the rules see what the reference's see. Trees that keep
    the stacked layout themselves (the serving states) need no such
    step."""
    named = list(named_leaves(tree))
    paths = [reference_path(n) for n, _ in named]
    n_layers: dict[str, int] = {}
    for path, layer in paths:
        if layer is not None:
            n_layers[path] = max(n_layers.get(path, 0), layer + 1)
    out: dict[str, Any] = {}
    memo: dict[str, Any] = {}
    for (name, t), (path, layer) in zip(named, paths):
        if stacked and layer is not None:
            if path not in memo:
                memo[path] = fn(path, torch.empty(
                    (n_layers[path],) + tuple(t.shape), dtype=t.dtype,
                    device="meta"))
            out[name] = memo[path]
        else:
            out[name] = fn(path, t)
    return out


def tree_param_count(tree: Any) -> int:
    """Total number of scalar elements of a tree's leaves."""
    return sum(t.numel() for _, t in named_leaves(tree))


def tree_bytes(tree: Any) -> int:
    """Total bytes of a tree's leaves."""
    return sum(t.numel() * t.element_size() for _, t in named_leaves(tree))

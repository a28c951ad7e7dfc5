"""The port's model code on DTensors: the few helpers it needs.

Where the reference hands a step to GSPMD (``jax.jit`` with shardings),
the port places the parameters, the batch and the states as DTensors
(``distributed/sharding.py``) and runs its own modules on them: DTensor
propagates the placements op by op. Where an op has no DTensor rule, or
is a hand-written kernel (flash, wkv6), the model runs it on each rank's
local shard through ``local_map`` (``run_local``): the head-local part of
attention, the RWKV time-mix's recurrence and groupnorm, hymba's SSD
branch, the vocab-parallel embedding lookup. ``shard_map`` is the
reference's ``shard_map`` for the layers whose schedule is written out
(``models/moe_sharded.py``, ``models/block_sharded.py``). Plain tensors
pass through every helper unchanged, so the unsharded path is the same
code.
"""
from __future__ import annotations

from typing import Callable

import torch


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The logical tensor of a DTensor (gathered), or ``t`` itself."""
    return t.full_tensor() if is_dtensor(t) else t


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (its storage, not a copy), or
    ``t`` itself."""
    return t.to_local() if is_dtensor(t) else t


def like(ref: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` (a plain tensor every rank holds alike: positions, masks) as
    a replicated DTensor on ``ref``'s mesh when ``ref`` is a DTensor."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def settle(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A block's output placed as the residual stream ``ref``: a partial
    sum (a row-parallel product's) is reduced here, once, as the
    reference's GSPMD reduces it after each block (Megatron's
    all-reduce); a plain tensor is returned as it is."""
    if is_dtensor(t) and t.placements != ref.placements:
        return t.redistribute(placements=ref.placements)
    return t


def align(t: torch.Tensor, ref: torch.Tensor, ref_dim: int, dim: int
          ) -> torch.Tensor:
    """A replicated per-head tensor ``t`` (``u``, ``a_log``, ...) split as
    ``ref`` splits its heads: its ``dim`` sharded where ``ref``'s
    ``ref_dim`` is (a local slice, no collective), replicated elsewhere.
    Plain tensors are returned as they are."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import Replicate, Shard

    return t.redistribute(placements=[
        Shard(dim) if p.is_shard(ref_dim) else Replicate()
        for p in ref.placements])


def mesh_coordinate(t: torch.Tensor, axis: str) -> tuple[int, int]:
    """(this rank's index, size) along mesh axis ``axis`` of a DTensor's
    mesh; (0, 1) for a plain tensor or a mesh without that axis."""
    if not is_dtensor(t):
        return 0, 1
    mesh = t.device_mesh
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        return 0, 1
    return mesh.get_local_rank(axis), mesh.size(names.index(axis))


def split_along(t: torch.Tensor, axis: str) -> int | None:
    """The tensor dim a DTensor is sharded along on mesh axis ``axis``,
    else None."""
    if not is_dtensor(t):
        return None
    names = t.device_mesh.mesh_dim_names or ()
    if axis not in names:
        return None
    pl = t.placements[names.index(axis)]
    return pl.dim if pl.is_shard() else None


def run_local(fn: Callable, lead: torch.Tensor, args: tuple, *,
              out_placements, **kwargs):
    """``fn(*args, **kwargs)`` on each rank's local shards (``local_map``)
    when ``lead`` is a DTensor, else as it is. The DTensors among ``args``
    (nested in tuples and NamedTuples too) become their local tensors, the
    outputs DTensors with ``out_placements``: the placements of the one
    output, or a list of them, one per output; None stands for ``lead``'s
    placements.

    Gradients: the work is split as ``lead`` is. An input replicated along
    a mesh dim that ``lead`` shards is read whole by every rank, each of
    which differentiates only its share of the work, so its gradient there
    is a partial sum (``Partial``) that DTensor reduces."""
    if not is_dtensor(lead):
        return fn(*args, **kwargs)
    from torch.distributed.tensor import Partial, Placement
    from torch.distributed.tensor.experimental import local_map
    from torch.utils import _pytree as pytree

    flat, _ = pytree.tree_flatten(args)
    grads = []
    for a in flat:
        if is_dtensor(a):
            if any(p.is_partial() for p in a.placements):
                raise ValueError("run_local on a partial sum: reduce it "
                                 "first (settle)")
            grads.append(tuple(
                Partial() if lp.is_shard() and p.is_replicate() else p
                for lp, p in zip(lead.placements, a.placements)))
        else:
            grads.append(None)
    multi = isinstance(out_placements, list) and not isinstance(
        out_placements[0], Placement)
    # local_map reads a tuple as one placement list per output
    outs = tuple(list(lead.placements if p is None else p)
                 for p in (out_placements if multi else [out_placements]))
    mapped = local_map(fn, out_placements=outs if multi else outs[0],
                       in_grad_placements=tuple(grads))
    return mapped(*args, **kwargs)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k):
        ctx.k = k
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.k, None


def shard_map(fn: Callable, mesh, in_placements, out_placements):
    """The reference's ``shard_map`` (``check_vma=False``) on DTensors:
    ``fn`` runs on each rank's local blocks, its inputs placed first as
    ``in_placements`` says (a redistribute where they differ; a plain
    tensor is taken as replicated; None passes an argument as it is),
    its outputs assembled as ``out_placements`` says (a tuple of
    outputs, or one).

    Differentiation follows the reference's: an input replicated along a
    mesh dim gets the sum of the ranks' gradients there (``Partial``), and
    the cotangent of an output replicated along mesh dims is shared out
    among their ranks (divided by their count), so collectives inside
    ``fn`` transpose as in ``distributed/collectives.py`` and the whole
    gives the gradient of the function the ranks compute together."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    def mapped(*args):
        local_args = []
        for a, pl in zip(args, in_placements):
            if pl is None:
                local_args.append(a)
                continue
            pl = tuple(pl)
            if not is_dtensor(a):
                a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False)
            if a.placements != pl:
                a = a.redistribute(placements=pl)
            local_args.append(a.to_local(grad_placements=[
                Partial() if p.is_replicate() else p for p in pl]))
        outs = fn(*local_args)
        single = not isinstance(outs, tuple)
        result = []
        for o, pl in zip((outs,) if single else outs,
                         [out_placements] if single else out_placements):
            k = 1
            for i, p in enumerate(pl):
                if p.is_replicate():
                    k *= mesh.size(i)
            if k > 1 and o.requires_grad:
                o = _ScaleGrad.apply(o, k)
            result.append(DTensor.from_local(o, mesh, tuple(pl),
                                             run_check=False))
        return result[0] if single else tuple(result)

    return mapped

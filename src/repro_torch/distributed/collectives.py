"""The collectives of the sharded LM layers: differentiable, and counted.

The reference's ``shard_map`` layers (``models/moe_sharded.py``,
``models/block_sharded.py``) and its int8 cross-pod reduction
(``distributed/compress.py``) issue their collectives by hand; so do the
port's, through these functions on a ``torch.distributed`` group (a mesh
axis's, ``axis_group``). Each is an autograd function whose backward is
the transpose the reference's differentiation gives it:

  all_gather (tiled, along ``dim``)   <-> reduce_scatter (sum)
  all_to_all (split one dim, concat another) <-> the reverse all_to_all
  psum (all-reduce sum)              <-> psum

Counting. The reference reads its collectives from the compiled HLO
(``launch/hlo_analysis.py``); the port has no compiled program, so it
counts where the collectives are issued, as ``AgentGroup.comm_bytes``
does for the agent axis: ``LEDGER`` records, per op (in the reference's
names), the calls, the bytes of each rank's result (the reference's
``raw_bytes``) and the ring wire bytes, ``raw × _WIRE_FACTOR[op](n)`` for
a group of n ranks (``launch/hlo_analysis.py``'s table), backward
collectives included, and each call reports itself to an installed cost
recorder (``obs/costs.py``). DTensor's own redistributes (the propagated
path) are not issued here: the cost recorder's dispatch mode counts them
(``obs.costs.record_call``), as ``launch/dryrun.py`` does.

Host staging. Four ranks on one card cannot use NCCL (it refuses two
ranks on one GPU), so they use ``gloo``, which carries CUDA tensors in
every collective issued here. DTensor's own all-gather (the functional
collectives' ``all_gather_tensor``, behind every Shard -> Replicate
redistribute) kills the process with a segmentation fault on CUDA tensors
under gloo (torch 2.11 on the H100 machine; plain
``all_gather_into_tensor`` works). ``stage_gloo_all_gather`` routes that
one through host memory: a process of a gloo world calls it, explicitly;
NCCL never stages, and the computation stays on the card.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from repro_torch.launch.hlo_analysis import _WIRE_FACTOR
from repro_torch.obs.costs import current_recorder


@dataclass
class CommLedger:
    raw_bytes: dict = field(default_factory=dict)
    wire_bytes: dict = field(default_factory=dict)
    count: dict = field(default_factory=dict)
    staged: dict = field(default_factory=dict)   # op -> calls via host

    def record(self, op: str, n: int, nbytes: int) -> None:
        self.raw_bytes[op] = self.raw_bytes.get(op, 0) + nbytes
        self.wire_bytes[op] = (self.wire_bytes.get(op, 0.0)
                               + nbytes * _WIRE_FACTOR[op](n))
        self.count[op] = self.count.get(op, 0) + 1

    def total_wire(self) -> float:
        return float(sum(self.wire_bytes.values()))

    def reset(self) -> None:
        self.raw_bytes.clear()
        self.wire_bytes.clear()
        self.count.clear()
        self.staged.clear()


LEDGER = CommLedger()


def axis_group(mesh, axes):
    """The process group over mesh axis (or axes, major to minor) ``axes``
    of a ``DeviceMesh``: several axes are flattened into one group whose
    ranks run major to minor, the reference's order for a tuple of
    axes."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def _count(op: str, out: torch.Tensor, group) -> None:
    """Count one collective of result ``out`` in ``LEDGER`` and in an
    installed cost recorder."""
    n, nbytes = dist.get_world_size(group), out.numel() * out.element_size()
    LEDGER.record(op, n, nbytes)
    rec = current_recorder()
    if rec is not None:
        rec.collective(op, nbytes, n)


def _issue(op: str, out: torch.Tensor, inp: torch.Tensor, group, call):
    """Run ``call(out, inp)`` (a collective) and count it."""
    _count(op, out, group)
    call(out, inp)
    return out


def stage_gloo_all_gather() -> None:
    """Route DTensor's all-gather of CUDA tensors through host memory (see
    the module's docstring). For a process whose world is gloo only; each
    staged call is counted in ``LEDGER.staged["all-gather"]``."""
    import torch.distributed._functional_collectives as funcol

    for name in ("all_gather_tensor", "all_gather_single"):
        orig = getattr(funcol, name, None)
        if orig is None or getattr(orig, "_host_staged", False):
            continue

        def staged(t, *args, _orig=orig, **kwargs):
            if not t.is_cuda:
                return _orig(t, *args, **kwargs)
            LEDGER.staged["all-gather"] = LEDGER.staged.get(
                "all-gather", 0) + 1
            out = _orig(t.cpu(), *args, **kwargs)
            if isinstance(out, funcol.AsyncCollectiveTensor):
                out = out.wait()
            return out.to(t.device)

        staged._host_staged = True
        setattr(funcol, name, staged)


def _all_gather(x, group, dim):
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + xt.shape[1:])
    _issue("all-gather", out, xt, group,
           lambda o, i: dist.all_gather_into_tensor(o, i, group=group))
    return out.movedim(0, dim)


def _reduce_scatter(x, group, dim):
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n,) + xt.shape[1:])
    _issue("reduce-scatter", out, xt, group,
           lambda o, i: dist.reduce_scatter_tensor(o, i, group=group))
    return out.movedim(0, dim)


def _all_to_all(x, group, split_dim, concat_dim):
    n = dist.get_world_size(group)
    inp = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    out = torch.empty_like(inp)
    _issue("all-to-all", out, inp, group,
           lambda o, i: dist.all_to_all_single(o, i, group=group))
    return torch.cat(out.unbind(0), dim=concat_dim)


def _psum(x, group):
    out = x.contiguous().clone()
    _count("all-reduce", out, group)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, concat_dim, split_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.group), None


def all_gather(x, group, dim: int):
    """The tiled all-gather along ``dim`` (rank order)."""
    return _AllGather.apply(x, group, dim)


def reduce_scatter(x, group, dim: int):
    """The tiled sum-reduce-scatter along ``dim`` (``psum_scatter``)."""
    return _ReduceScatter.apply(x, group, dim)


def all_to_all(x, group, split_dim: int, concat_dim: int):
    """The tiled all-to-all: ``x`` split into n chunks along ``split_dim``,
    chunk j to rank j, the received chunks concatenated along
    ``concat_dim`` in rank order."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def psum(x, group):
    """The all-reduce sum (``jax.lax.psum``)."""
    return _Psum.apply(x, group)


def pmean(x, group):
    return psum(x, group) / dist.get_world_size(group)

"""Cost telemetry: what one window executor costs.

Port of ``repro/obs/costs.py``. The reference reads what a compiled
executor *must* cost from XLA's ahead-of-time artefacts: FLOPs and bytes
accessed (``cost_analysis``), the argument / output / temp decomposition
(``memory_analysis``) and the collectives in the post-optimization HLO,
each classified by the dynamic loop it sits in. The port has no compiled
program. It measures **one executed call** of the executor instead
(``executor_cost``), on clones of its arguments:

  * ``flops``: ``torch.utils.flop_counter``'s formulas (the matmul
    family), one per output element of an elementwise arithmetic op and
    n - 1 per n-element reduction (XLA's HLO cost model), and the work
    the hand-written kernels report;
  * ``bytes_accessed``: every dispatched aten op's input and output
    bytes (views and allocations count 0, a factory such as
    ``new_zeros`` its result alone; an indexing op -- a gather
    such as ``x[idx]``, or a scatter into ``x`` in place -- counts its
    indices and values and the elements of ``x`` it touches, not the
    whole of ``x``), and the kernels' bytes. An eager op that copies a
    whole tensor (``cat``, an out-of-place scatter) moves it all and
    counts it all;
  * ``argument_bytes`` / ``output_bytes``: distinct storages;
  * ``temp_bytes``: the peak of live bytes during the call less the
    arguments and the new outputs (the allocator's peak on the card, the
    dispatch mode's own tally of live storages on the CPU);
  * ``collectives``: the collectives the call issued, by call site and
    loop context (``parse_collectives``).

**Counts differ by design.** The reference counts each loop body once
(``cost_analysis`` and its HLO walk see the body, not the trips); the
port counts what it executes, every wave included. Its collectives keep
the reference's accounting all the same: each call site is one
``CollectiveOp`` with the bytes of one execution, classified by loop
depth, to be multiplied by executed iteration counts from outside.

**The record.** A ``CostRecorder`` is installed with ``recording()`` the
way ``obs.trace.tracing()`` installs a tracer, and read through
``current_recorder()``; with none installed (the default) every site
pays one ``is None`` check and no op and no host sync. While one is:

  * loops enter ``loop(trips)``: a known trip count multiplies into
    ``static_mult``; ``None`` is a data-dependent loop and goes one
    ``depth`` deeper — the wave loop is depth 1, the split rung's chunks
    depth 2 (``engine/sharded.py``), as in the reference's HLO walk.
    ``loop(trips, run)`` marks a loop of ``trips`` iterations of one
    program of which only ``run`` execute, each standing for
    ``trips // run`` (``repeat``): the dry run's replayed microbatch
    loop, on the meta device, as the reference's walk counts a static
    loop's body once times its trips;
  * each collective call site reports ``(op, bytes of one unit per rank,
    group size, units)``: ``units`` lets one port collective stand for
    several reference iterations (the split rung ships a wave's whole
    chunk range in one all-reduce: ``c1 - c0`` units at depth 2);
  * each hand-written kernel's wrapper reports its launch and its work
    (``kernels/<name>/ops.py::work``): the kernels run through ctypes,
    so no dispatch mode sees them.

The cross-check identity is the reference's: per-iteration collective
bytes × executed iterations (``ShardedEngine.comm_iteration_counts``)
equal the runtime comm ledger's ``comm_bytes_total`` exactly
(``ledger_cross_check``).
"""
from __future__ import annotations

import contextlib
import math
import sys
import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Mapping, Sequence

import torch

from repro_torch.launch.hlo_analysis import _WIRE_FACTOR


# --------------------------------------------------------------------------
# the record of one executed program

@dataclass(frozen=True)
class CollectiveEvent:
    """One collective as it executed: ``units`` executions of ``nbytes``
    result bytes per rank each, in a group of ``group_size``, at loop
    context (``static_mult``, ``depth``), from call site ``site``."""

    op: str
    nbytes: int
    units: int
    group_size: int | None
    static_mult: int
    depth: int
    site: tuple
    type_str: str
    repeat: int = 1      # executions this record stands for (replay)


@dataclass
class CollectiveTrace:
    """The collectives of one executed program, in execution order, and
    the sites of the data-dependent loops it entered."""

    events: list = field(default_factory=list)
    dynamic_loops: set = field(default_factory=set)


_NOT_SITES = frozenset((__file__, contextlib.__file__))


def _site() -> tuple:
    """The call site: (file, line) of the Python frames on the stack, the
    recorder's, ``contextlib``'s and torch's left out."""
    out = []
    f = sys._getframe(1)
    while f is not None and len(out) < 24:
        name = f.f_code.co_filename
        if name not in _NOT_SITES and "/torch/" not in name:
            out.append((name, f.f_lineno))
        f = f.f_back
    return tuple(out)


class CostRecorder:
    """Collects one executed program's collectives (``trace``) and the
    hand-written kernels' launches and work (``kernels``: name ->
    {"launches", "bytes", "ops"})."""

    def __init__(self):
        self.trace = CollectiveTrace()
        self.kernels: dict[str, dict] = {}
        self._static = 1
        self._depth = 0
        self.repeat = 1

    @contextmanager
    def loop(self, trips: int | None = None, run: int | None = None):
        """The body of a loop: ``trips`` known multiplies into the static
        multiplier, ``None`` (data-dependent) goes one depth deeper.
        ``run`` (dividing ``trips``): the iterations that run, each
        standing for ``trips // run``."""
        saved = self._static, self._depth, self.repeat
        if trips is None:
            self._depth += 1
            self.trace.dynamic_loops.add(_site()[:1])
        else:
            self._static *= int(trips)
            if run is not None:
                if run <= 0 or trips % run:
                    raise ValueError(f"{run} runs cannot stand for a loop "
                                     f"of {trips} trips")
                self.repeat *= int(trips) // int(run)
        try:
            yield
        finally:
            self._static, self._depth, self.repeat = saved

    def collective(self, op: str, nbytes: int, group_size: int | None,
                   units: int = 1, *, type_str: str | None = None) -> None:
        """Record ``units`` executions of collective ``op`` of ``nbytes``
        result bytes per rank each (``_WIRE_FACTOR``'s op names) in a
        group of ``group_size`` ranks (None: no group, as a
        collective-permute's pairs)."""
        if op not in _WIRE_FACTOR:
            raise ValueError(f"no wire model for collective {op!r}")
        if units <= 0:
            return
        nbytes = int(nbytes)
        if type_str is None:
            type_str = f"u8[{nbytes}]"
        self.trace.events.append(CollectiveEvent(
            op=op, nbytes=nbytes, units=int(units),
            group_size=None if group_size is None else int(group_size),
            static_mult=self._static,
            depth=self._depth, site=_site(),
            type_str=type_str, repeat=self.repeat))

    def kernel(self, name: str, nbytes: float, ops: float) -> None:
        """Record one launch of kernel ``name`` and its work."""
        k = self.kernels.setdefault(name, {"launches": 0, "bytes": 0,
                                           "ops": 0})
        k["launches"] += self.repeat
        k["bytes"] += nbytes * self.repeat
        k["ops"] += ops * self.repeat


_CURRENT: CostRecorder | None = None


def current_recorder() -> CostRecorder | None:
    """The installed recorder, or None (the default: recording off)."""
    return _CURRENT


@contextmanager
def recording(recorder: CostRecorder | None = None):
    """Install a recorder for the block (the previous one after)."""
    global _CURRENT
    prev = _CURRENT
    rec = recorder if recorder is not None else CostRecorder()
    _CURRENT = rec
    try:
        yield rec
    finally:
        _CURRENT = prev


def loop(rec: CostRecorder | None, trips: int | None = None,
         run: int | None = None):
    """``rec.loop(trips, run)``, or a context that does nothing without a
    recorder (the call sites' one ``is None`` check)."""
    return (contextlib.nullcontext() if rec is None
            else rec.loop(trips, run))


# --------------------------------------------------------------------------
# collectives by loop context

@dataclass(frozen=True)
class CollectiveOp:
    """One collective call site, with its loop context."""

    op: str              # "all-reduce" | "all-gather" | ...
    type_str: str        # result type of one unit, per rank
    bytes_per_call: int  # receive bytes of one unit
    static_mult: int     # product of the known trip counts around it
    depth: int           # data-dependent loop nesting depth
    group_size: int | None


@dataclass
class HloCollectives:
    """All collectives of one executor, by call site and loop context."""

    ops: list[CollectiveOp] = field(default_factory=list)

    def bytes_by_depth(self) -> dict[int, int]:
        """Per-call receive bytes summed per dynamic depth (static loop
        multipliers folded in) — multiply by executed iteration counts
        to get run totals."""
        out: dict[int, int] = {}
        for o in self.ops:
            out[o.depth] = out.get(o.depth, 0) + o.bytes_per_call * o.static_mult
        return out

    def total_bytes(self, iters_by_depth: Mapping[int, int]) -> int:
        """Total per-rank receive bytes given the executed iteration
        count of each dynamic loop depth (depth 0 ops run once per
        executor call — pass ``{0: n_calls}`` to count them)."""
        return sum(b * int(iters_by_depth.get(d, 0))
                   for d, b in self.bytes_by_depth().items())

    def wire_bytes(self, iters_by_depth: Mapping[int, int]) -> float:
        """Ring-algorithm wire bytes (``_WIRE_FACTOR``) under the same
        executed-iteration accounting."""
        total = 0.0
        for o in self.ops:
            n = o.group_size or 2
            total += (o.bytes_per_call * o.static_mult
                      * int(iters_by_depth.get(o.depth, 0))
                      * _WIRE_FACTOR[o.op](n))
        return total


def parse_collectives(trace: CollectiveTrace) -> HloCollectives:
    """One ``CollectiveOp`` per call site and loop context of an executed
    trace, with the bytes of one unit. A site that reports different
    per-unit bytes at one depth raises: the identity of
    ``ledger_cross_check`` would not hold, and that is the bug this
    telemetry exists to catch."""
    out = HloCollectives()
    seen: dict[tuple, CollectiveOp] = {}
    for e in trace.events:
        key = (e.site, e.op, e.depth)
        op = seen.get(key)
        if op is None:
            op = CollectiveOp(op=e.op, type_str=e.type_str,
                              bytes_per_call=e.nbytes,
                              static_mult=e.static_mult, depth=e.depth,
                              group_size=e.group_size)
            seen[key] = op
            out.ops.append(op)
        elif (op.bytes_per_call, op.static_mult, op.group_size) != (
                e.nbytes, e.static_mult, e.group_size):
            raise ValueError(
                f"{e.op} at depth {e.depth} from one call site reports "
                f"{e.nbytes} bytes a unit (x{e.static_mult}, group "
                f"{e.group_size}), earlier {op.bytes_per_call} "
                f"(x{op.static_mult}, group {op.group_size}): "
                f"{e.site[:2]}")
    return out


# --------------------------------------------------------------------------
# one executed call, counted

#: reductions: n - 1 operations per n-element reduction
_REDUCTIONS = frozenset(
    ("sum", "mean", "prod", "amax", "amin", "max", "min", "argmax",
     "argmin", "any", "all", "nansum", "var", "std", "logsumexp", "norm",
     "linalg_vector_norm"))

#: pointwise-tagged ops that move data and compute nothing
_MOVES = frozenset(("clone", "copy", "_to_copy", "fill", "zero",
                    "lift_fresh_copy", "detach_copy", "alias_copy"))

#: ops that allocate and neither read nor write (0 bytes)
_ALLOCS = frozenset(("empty", "empty_like", "empty_strided",
                     "new_empty", "new_empty_strided"))

#: ops that read the elements of their first argument named by their
#: indices: indices + 2 x the result (the elements read, then written)
_GATHERS = frozenset(("index", "index_select", "gather", "take",
                      "take_along_dim", "embedding"))

#: in-place scatters into their first argument: indices and values read,
#: the touched elements written (and read first where they accumulate)
_SCATTERS = frozenset(("index_put_", "_index_put_impl_", "scatter_",
                       "scatter_add_", "scatter_reduce_", "index_add_",
                       "index_copy_", "index_fill_"))

#: the functional collectives (DTensor's redistributes), in the
#: reference's names
_FUNCOL = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
           "all_reduce_coalesced": "all-reduce",
           "all_gather_into_tensor": "all-gather",
           "all_gather_into_tensor_coalesced": "all-gather",
           "reduce_scatter_tensor": "reduce-scatter",
           "reduce_scatter_tensor_coalesced": "reduce-scatter",
           "all_to_all_single": "all-to-all"}

_DTYPE_NAMES = {torch.float64: "f64", torch.float32: "f32",
                torch.float16: "f16", torch.bfloat16: "bf16",
                torch.int64: "s64", torch.int32: "s32", torch.int16: "s16",
                torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred"}


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; any other tensor as it is."""
    return getattr(t, "_local_tensor", t)


def _tensors(tree, out=None) -> list:
    """The tensors in nested tuples, lists and dicts (an op's arguments
    or results; a call's), in order."""
    if out is None:
        out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor):
    return _plain(t).untyped_storage()._cdata


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct storages under ``tensors``."""
    seen = {}
    for t in tensors:
        p = _plain(t)
        seen[_storage_key(p)] = p.untyped_storage().nbytes()
    return sum(seen.values())


def _type_str(t: torch.Tensor) -> str:
    dims = ",".join(str(d) for d in t.shape)
    return f"{_DTYPE_NAMES.get(t.dtype, 'u8')}[{dims}]"


def _indexed_numel(t: torch.Tensor, indices) -> int:
    """Elements of ``t[indices]`` (``aten.index``'s index list, None for
    a full dimension). A boolean mask counts every element it covers:
    its true count is data."""
    shapes, rest, d = [], 1, 0
    for i in indices:
        if i is None:
            rest *= t.shape[d]
            d += 1
        elif i.dtype in (torch.bool, torch.uint8):
            shapes.append((i.numel(),))
            d += i.dim()
        else:
            shapes.append(tuple(i.shape))
            d += 1
    for size in t.shape[d:]:
        rest *= size
    return rest * (math.prod(torch.broadcast_shapes(*shapes))
                   if shapes else 1)


def _scatter_bytes(base: str, args, kwargs, ins) -> int:
    """Bytes of an in-place scatter (``_SCATTERS``) into ``args[0]``."""
    t = args[0]
    if base in ("index_put_", "_index_put_impl_"):
        touched = _indexed_numel(t, args[1])
        acc = bool(args[3] if len(args) > 3 else
                   kwargs.get("accumulate", False))
    elif base.startswith("scatter"):
        touched = args[2].numel()
        acc = base != "scatter_" or "reduce" in kwargs or len(args) > 4
    else:                   # index_add_, index_copy_, index_fill_
        touched = args[2].numel() * (t.numel() // max(t.shape[args[1]], 1)
                                     if t.dim() else 1)
        acc = base == "index_add_"
    return (sum(_nbytes(x) for x in ins[1:])
            + touched * t.element_size() * (2 if acc else 1))


def _in_alltoall_fallback() -> bool:
    """Whether the running functional collective is DTensor's stand-in
    for an all-to-all on a CPU mesh (gloo has none): an all-gather whose
    result ``shard_dim_alltoall`` chunks."""
    f = sys._getframe(2)
    while f is not None:
        code = f.f_code
        if code.co_name == "shard_dim_alltoall" and \
                code.co_filename.endswith("_collective_utils.py"):
            return True
        f = f.f_back
    return False


def _group_size(func, args, kwargs) -> int:
    """The size of a functional collective's group (its ``group_name``
    argument)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    bound = dict(zip((a.name for a in func._schema.arguments), args))
    bound.update(kwargs)
    return _resolve_process_group(bound["group_name"]).size()


def _make_mode(recorder: CostRecorder, tally: bool):
    """The dispatch mode that counts one call (built on first use: the
    port imports this module everywhere, torch's dispatch internals only
    here)."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode

    registry = FlopCounterMode().flop_registry
    infos: dict = {}

    def info(func):
        """(namespace, base name, counts bytes, flop rule) of an op."""
        ns, _, base = func._schema.name.partition("::")
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)
        if func.overloadpacket in registry:
            rule = registry[func.overloadpacket]
        elif torch.Tag.pointwise in func.tags and \
                base.rstrip("_") not in _MOVES:
            rule = "pointwise"
        elif base in _REDUCTIONS:
            rule = "reduction"
        else:
            rule = None
        infos[func] = out = (ns, base, not view and base not in _ALLOCS,
                             rule)
        return out

    class CostMode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0
            self.live = 0
            self.peak = 0
            self.new: dict = {}    # storage key -> bytes, made in the call

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(t is not torch.Tensor for t in types):
                if any(issubclass(t, FakeTensor) for t in types):
                    # DTensor's sharding propagation: no work of the call
                    return func(*args, **kwargs)
                # a tensor subclass (DTensor, an async collective's
                # result) desugars first into ops on plain tensors,
                # which come back through this mode
                return NotImplemented
            out = func(*args, **kwargs)
            self._count(func, args, kwargs, out)
            return out

        def _count(self, func, args, kwargs, out):
            ns, base, moves, rule = infos.get(func) or info(func)
            ins = _tensors(kwargs, _tensors(args))
            outs = _tensors(out)
            rep = recorder.repeat
            if ns in ("_c10d_functional", "c10d_functional") and \
                    base in _FUNCOL:
                n = _group_size(func, args, kwargs)
                op = _FUNCOL[base]
                for o in outs:
                    nbytes = _nbytes(o)
                    if op == "all-gather" and _in_alltoall_fallback():
                        # counted as the all-to-all it stands for (what
                        # a CUDA mesh issues): its result is one chunk
                        op, nbytes = "all-to-all", nbytes // n
                    recorder.collective(op, nbytes, n,
                                        type_str=_type_str(o))
            elif ns == "_dtensor" and base == "shard_dim_alltoall":
                n = _group_size(func, args, kwargs)
                for o in outs:
                    recorder.collective("all-to-all", _nbytes(o), n,
                                        type_str=_type_str(o))
            if not moves:
                pass
            elif base in _GATHERS:
                self.bytes += rep * (sum(_nbytes(t) for t in ins[1:])
                                     + 2 * sum(_nbytes(t) for t in outs))
            elif base in _SCATTERS:
                self.bytes += rep * _scatter_bytes(base, args, kwargs, ins)
            elif base.startswith("new_") or base.endswith("_like"):
                # a factory reads its tensor argument's dtype and device
                self.bytes += rep * sum(_nbytes(t) for t in outs)
            else:
                self.bytes += rep * (sum(_nbytes(t) for t in ins)
                                     + sum(_nbytes(t) for t in outs))
            if rule is None or not outs:
                pass
            elif rule == "pointwise":
                self.flops += rep * outs[0].numel()
            elif rule == "reduction":
                if ins:
                    self.flops += rep * max(ins[0].numel()
                                            - outs[0].numel(), 0)
            else:
                self.flops += rep * rule(*args, **kwargs, out_val=out)
            if tally:
                self._tally(ins, outs)

        def _tally(self, ins, outs):
            old = {_storage_key(t) for t in ins}
            for t in outs:
                key = _storage_key(t)
                if key in old or key in self.new:
                    continue
                nb = t.untyped_storage().nbytes()
                self.new[key] = nb
                self.live += nb
                self.peak = max(self.peak, self.live)
                weakref.finalize(t, self._free, key)

        def _free(self, key):
            self.live -= self.new.pop(key, 0)

    return CostMode()


@dataclass
class CallRecord:
    """What one executed call cost (``record_call``)."""

    flops: float
    bytes_accessed: float
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    device_peak_bytes: int | None
    trace: CollectiveTrace
    kernels: dict


def record_call(fn: Callable, *args) -> CallRecord:
    """Run ``fn(*args)`` once under the cost mode and a recorder. On the
    card the temp bytes are the
    allocator's peak over the call (fenced by a synchronize on each
    side); on the CPU the mode's tally of the storages the call made; on
    the meta device, where nothing is stored, 0."""
    tensors = _tensors(args)
    types = {_plain(t).device.type for t in tensors}
    dev = next((_plain(t).device for t in tensors
                if _plain(t).device.type == "cuda"), None)
    arg_keys = {_storage_key(t) for t in tensors}
    rec = CostRecorder()
    mode = _make_mode(rec, tally=dev is None and "meta" not in types)
    if dev is not None:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    with recording(rec), mode:
        out = fn(*args)
    outs = _tensors(out)
    new_out = _storage_bytes([t for t in outs
                              if _storage_key(t) not in arg_keys])
    peak = None
    if dev is not None:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        temp = peak - base - new_out
    else:
        temp = mode.peak - new_out
    kflops = sum(k["ops"] for k in rec.kernels.values())
    kbytes = sum(k["bytes"] for k in rec.kernels.values())
    return CallRecord(flops=float(mode.flops + kflops),
                      bytes_accessed=float(mode.bytes + kbytes),
                      argument_bytes=_storage_bytes(tensors),
                      output_bytes=_storage_bytes(outs),
                      temp_bytes=max(int(temp), 0), device_peak_bytes=peak,
                      trace=rec.trace, kernels=rec.kernels)


@dataclass
class ExecutorCost:
    """Cost summary of one engine executor (one executed call)."""

    name: str
    flops: float                 # executed: every wave counted
    bytes_accessed: float        # same
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    collectives: HloCollectives
    #: kernel name -> {"launches", "bytes", "ops"} the kernels reported
    kernels: dict = field(default_factory=dict)
    #: the allocator's peak over the call (None off the card)
    device_peak_bytes: int | None = None

    @property
    def peak_bytes(self) -> int:
        """Conservative peak live bytes: arguments + outputs + temps."""
        return self.argument_bytes + self.output_bytes + self.temp_bytes

    def as_row(self, iters_by_depth: Mapping[int, int] | None = None
               ) -> dict:
        """Flat JSON-safe dict for benchmark rows; with iteration counts
        the collective total is resolved, otherwise per-depth per-call
        bytes are recorded for later resolution."""
        row = {
            "executor": self.name,
            "flops": float(self.flops),
            "bytes_accessed": float(self.bytes_accessed),
            "argument_bytes": int(self.argument_bytes),
            "output_bytes": int(self.output_bytes),
            "temp_bytes": int(self.temp_bytes),
            "peak_bytes": int(self.peak_bytes),
            "collective_bytes_by_depth": {
                str(d): int(b)
                for d, b in self.collectives.bytes_by_depth().items()},
        }
        if iters_by_depth is not None:
            row["collective_bytes"] = int(
                self.collectives.total_bytes(iters_by_depth))
        return row


def _clone(args):
    from torch.utils._pytree import tree_map

    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, args)


def executor_cost(fn: Callable, *args, name: str = "executor"
                  ) -> ExecutorCost:
    """Run one executor once on clones of its tensor arguments (the
    caller's tensors stay bit for bit as they were, as the reference's
    lowering never executes) and count what it cost."""
    r = record_call(fn, *_clone(args))
    return ExecutorCost(
        name=name, flops=r.flops, bytes_accessed=r.bytes_accessed,
        argument_bytes=r.argument_bytes, output_bytes=r.output_bytes,
        temp_bytes=r.temp_bytes,
        collectives=parse_collectives(r.trace), kernels=r.kernels,
        device_peak_bytes=r.device_peak_bytes)


@dataclass(frozen=True)
class CrossCheck:
    """Recorded collective bytes vs the runtime comm ledger."""

    parsed_bytes: int
    ledger_bytes: int
    ratio: float
    ok: bool


def ledger_cross_check(costs: Mapping[str, ExecutorCost] | Sequence[ExecutorCost],
                       iters_by_depth: Mapping[int, int],
                       ledger_bytes: int, *, rtol: float = 0.0
                       ) -> CrossCheck:
    """Check the identity: per-iteration collective receive bytes ×
    executed iterations == the runtime comm ledger's byte total. Exact
    (``rtol=0``) on the sharded rungs — the ledger counts the same
    per-rank receive rows the call sites report."""
    if isinstance(costs, Mapping):
        costs = list(costs.values())
    parsed = sum(c.collectives.total_bytes(iters_by_depth) for c in costs)
    ledger = int(ledger_bytes)
    ratio = parsed / ledger if ledger else (1.0 if not parsed else float("inf"))
    ok = abs(parsed - ledger) <= rtol * max(ledger, 1)
    return CrossCheck(parsed_bytes=int(parsed), ledger_bytes=ledger,
                      ratio=ratio, ok=ok)

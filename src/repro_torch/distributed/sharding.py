"""The agent axis of the sharded wavefront engine on ``torch.distributed``,
and the LM mesh rules (the second half of this file).

Port of ``repro/distributed/sharding.py``. The reference shards agent
state over a 1-D ``("agents",)`` device mesh inside ``shard_map``; here a
process group takes the mesh's place and each rank holds one contiguous
row block of every state leaf (``AgentGroup``). Window-local scheduling objects
(recipes, levels, halos, slab layouts) stay replicated: every rank
computes them from the same key, so deriving them costs no communication.

Collectives. Every gather here is one collective per call, whatever the
number of state leaves: the rows of all leaves are packed side by side as
bytes ([h, row_bytes] uint8) and travel together.

  * a halo gather (``halo_gather``, ``wave_halo_gather``) is one
    ``all_reduce(SUM)`` of the packed rows: each real row has exactly one
    owner rank, which contributes its bytes while every other rank
    contributes zeros, so the byte-wise sum is exact for any dtype;
  * the replicated layout (``all_gather_rows``) is one ``all_gather`` of
    the packed row blocks.

``AgentGroup`` counts, at these call sites, the collectives issued and the
bytes each rank receives from them: over a run they equal the engine's
``comm_bytes_total`` exactly. The same call sites report each collective
to an installed cost recorder (``obs/costs.py``), with the loop it runs
in, for ``Engine.compiled_costs`` and the reference's cross-check
(``ledger_cross_check``). A world of one (no process group) issues no
collective — the reference's one-device mesh, whose psum is the
identity — but its call sites still count, so its ledger reads as the
reference's does.
"""
from __future__ import annotations

import math
import os
import re
from dataclasses import dataclass, replace
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.obs.costs import current_recorder, loop as cost_loop
from repro_torch.obs.profiler import annotate
from repro_torch.utils.pytree import tree_map_with_path_str
from repro_torch.utils.device import resolve_device


# --------------------------------------------------------------------------
# the agent group (the reference's agents_mesh / agent_state_shardings)

@dataclass
class AgentGroup:
    """One rank's view of the agent axis: the process group (None = a
    world of one, no collective), this rank, the world size, the device
    its rows live on, and the rows each rank owns (``shard_n``, set by
    ``for_agents`` once the agent count is known). ``collectives`` and
    ``comm_bytes`` count the collective call sites reached and the bytes
    received from them."""

    group: Any
    rank: int
    world_size: int
    device: torch.device
    shard_n: int = 0
    collectives: int = 0
    comm_bytes: int = 0

    def for_agents(self, n: int) -> "AgentGroup":
        """The group laid out over ``n`` agents: contiguous row blocks of
        ceil(n / world_size) rows (the last rank's block padded), the
        counters at zero."""
        return replace(self, shard_n=-(-n // self.world_size),
                       collectives=0, comm_bytes=0)

    @property
    def lo(self) -> int:
        """First global row of this rank's block."""
        return self.rank * self.shard_n

    @property
    def n_pad(self) -> int:
        return self.shard_n * self.world_size


def agent_group(group=None, device=None) -> AgentGroup:
    """The agent axis over ``group``: the given process group, else the
    default one when ``torch.distributed`` is initialized, else a world
    of one. ``device`` defaults to the card this rank runs on,
    ``cuda:<LOCAL_RANK>`` (or ``cuda:<rank>``) modulo the visible cards,
    and raises without one. The group's backend is used as it is; a
    group that cannot carry the device's tensors (NCCL and CPU tensors)
    raises."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        rank, world = 0, 1
    else:
        rank, world = dist.get_rank(group), dist.get_world_size(group)
    if device is None:
        resolve_device(None)  # raises without a card
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = resolve_device(device)
    if group is not None:
        backends = str(dist.get_backend(group)).lower()
        carried = {b.split(":")[0] for b in backends.split(",")
                   if ":" in b}
        if carried:
            ok = device.type in carried
        else:
            ok = not (backends == "nccl" and device.type != "cuda")
        if not ok:
            raise ValueError(f"the process group's backend {backends!r} "
                             f"cannot carry {device.type} tensors")
    return AgentGroup(group, rank, world, device)


# --------------------------------------------------------------------------
# packed collectives

def _leaves(x) -> dict:
    return x if isinstance(x, dict) else {"": x}


def _pack(parts: dict) -> torch.Tensor:
    """Leaves [h, ...] -> one [h, row_bytes] uint8 buffer."""
    cols = [p.reshape(p.shape[0], -1).contiguous().view(torch.uint8)
            for p in parts.values()]
    return cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)


def _unpack(buf: torch.Tensor, like: dict) -> dict:
    """Inverse of ``_pack``: slice each leaf's bytes back out of ``buf``
    with the dtype and trailing shape of the matching leaf of ``like``."""
    out, at = {}, 0
    for k, x in like.items():
        nb = x.element_size() * math.prod(x.shape[1:])
        col = buf[:, at:at + nb]
        if col.shape[1] != buf.shape[1]:
            col = col.contiguous()
        out[k] = col.view(x.dtype).reshape((buf.shape[0],) + x.shape[1:])
        at += nb
    return out


def _all_reduce_sum(buf: torch.Tensor, agents: AgentGroup,
                    units: int = 1) -> torch.Tensor:
    """The packed rows' all-reduce, counted; ``units`` equal row blocks
    of it stand for as many of the reference's collectives (the split
    rung's chunks)."""
    nbytes = buf.numel() * buf.element_size()
    agents.collectives += 1
    agents.comm_bytes += nbytes
    rec = current_recorder()
    if rec is not None:
        rec.collective("all-reduce", nbytes // units, agents.world_size,
                       units, type_str=f"u8[{buf.shape[0] // units},"
                                       f"{buf.shape[1]}]")
    if agents.group is not None:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=agents.group)
    return buf


def all_gather_rows(local, agents: AgentGroup, *, count: bool = True):
    """Every rank's row block, concatenated: the full [n_pad, ...] leaves
    (a tensor, or a dict of them, as ``local`` is) in one ``all_gather``
    of the packed blocks. ``count=False`` keeps the call out of the
    counters (the engine's final gather, which the reference's stats do
    not count either)."""
    leaves = _leaves(local)
    buf = _pack(leaves)
    if count:
        nbytes = buf.numel() * buf.element_size() * agents.world_size
        agents.collectives += 1
        agents.comm_bytes += nbytes
        rec = current_recorder()
        if rec is not None:
            rec.collective("all-gather", nbytes, agents.world_size,
                           type_str=f"u8[{agents.world_size * buf.shape[0]},"
                                    f"{buf.shape[1]}]")
    if agents.group is not None:
        out = buf.new_empty((agents.world_size * buf.shape[0],
                             buf.shape[1]))
        dist.all_gather(list(out.chunk(agents.world_size)), buf,
                        group=agents.group)
        buf = out
    full = _unpack(buf, leaves)
    return full if isinstance(local, dict) else full[""]


# --------------------------------------------------------------------------
# halo exchange (repro_torch.engine.sharded, halo mode)
#
# The sharded engine's communication-sparse mode. A window's tasks read a
# degree-bounded set of agent rows (the models' task_read_agents /
# task_write_agents contracts); instead of all-gathering the full O(N)
# state every wave, the schedule carries the flattened row list and each
# wave ships exactly those rows: every row has a unique owner rank, the
# owner contributes its value, a sum over the group delivers the row to
# all ranks. Per-wave comm is O(halo · trailing) values per rank versus
# the all_gather's O(N · trailing).

def window_halo(read_agents: torch.Tensor,
                write_agents: torch.Tensor) -> torch.Tensor:
    """Flatten a window's read ∪ write state rows into the gather list.

    read_agents [W, nr] / write_agents [W, nw] int32, -1 padded; returns
    [W·(nr+nw)] int32 with -1 marking unused slots. Static width — the
    halo is degree-bounded by construction (nr tracks max_degree), and
    duplicates are kept: the refresh scatter is idempotent, so dedup
    would only shuffle bytes without shrinking the buffer. Computed from
    replicated values, so every rank derives the identical list without
    communicating.
    """
    return torch.cat([read_agents.reshape(-1),
                      write_agents.reshape(-1)]).to(torch.int32)


def pair_halo(halo_prev: torch.Tensor,
              halo_next: torch.Tensor) -> torch.Tensor:
    """Halo for an overlapped window pair: the union of both windows'
    read ∪ write rows, realized by concatenation — [h_prev + h_next]
    int32, -1 slots preserved. During cross-window overlap a fused wave
    may execute window k tail tasks *and* window k+1 head tasks, so the
    per-wave gather must deliver every row either side can touch.
    Duplicates across the two windows are kept for the same reason
    ``window_halo`` keeps them.
    """
    return torch.cat([halo_prev, halo_next]).to(torch.int32)


def halo_gather(local, halo: torch.Tensor, agents: AgentGroup, *,
                units: int = 1):
    """Gather global rows ``halo`` from row-sharded leaves.

    ``local`` is this rank's contiguous row block [shard_n, ...] (a
    tensor, or a dict of leaves that share the row axis); ``halo`` [h]
    holds global row ids (-1 = unused, gathers zeros). Each real row has
    exactly one owner (id // shard_n), so masking non-owned slots to zero
    and summing over the group reconstructs the rows everywhere — one
    all-reduce of h packed rows instead of an all_gather of N. A
    zero-width halo (an empty wave's slab) is a clean no-op: no
    collective is issued and nothing is counted. ``units``: the equal
    row blocks the halo is made of, for the cost recorder.
    """
    leaves = _leaves(local)
    if halo.shape[0] == 0:
        out = {k: x.new_zeros((0,) + x.shape[1:]) for k, x in leaves.items()}
    else:
        with annotate("protocol.halo_gather", agents.device):
            lo, shard_n = agents.lo, agents.shard_n
            sel = (halo >= lo) & (halo < lo + shard_n)
            idx = torch.clamp(halo - lo, 0, shard_n - 1).long()
            buf = _pack({k: x[idx] for k, x in leaves.items()})
            buf = torch.where(sel[:, None], buf, 0)  # uint8 stays uint8
            out = _unpack(_all_reduce_sum(buf, agents, units), leaves)
    return out if isinstance(local, dict) else out[""]


def halo_scatter(full: torch.Tensor, halo: torch.Tensor,
                 gathered: torch.Tensor) -> torch.Tensor:
    """A copy of ``full`` with rows ``halo`` refreshed from ``gathered``
    (-1 slots dropped; duplicate slots write identical values)."""
    with annotate("protocol.halo_scatter", full.device):
        n = full.shape[0]
        ext = torch.cat([full, full.new_zeros((1,) + full.shape[1:])])
        ext.index_put_((torch.where(halo >= 0, halo, n).long(),), gathered)
        return ext[:n]


# ---- per-wave halo splitting (schedule-time comm specialization) ----------
#
# The window halo above is monolithic: every wave re-gathers the whole
# window's read ∪ write rows, O(W·slots) per wave however little wave w
# actually touches. But wave levels are known at schedule time, so the
# halo can be split into per-wave slabs: wave w gathers only the rows of
# tasks at level w. Slab widths are heavily skewed (level 0 usually holds
# most of a window's tasks, tail waves a handful), so the slabs are laid
# out *wave-major in fixed-size chunks* — wave w owns the chunk range
# [chunk_start[w], chunk_start[w+1]). Shipped volume per wave is
# ceil(rows_w / chunk)·chunk ≈ rows_w, summed over the window ≈ one window
# halo instead of n_waves of them. The reference gathers a wave's range
# chunk by chunk on the device; here the engine reads ``chunk_start`` on
# the host with the window's wave count (one copy) and gathers a wave's
# whole range in one collective (``wave_halo_gather``) — the same rows.

def wave_slab_counts(rows: torch.Tensor, levels: torch.Tensor, *,
                     n_waves_max: int) -> torch.Tensor:
    """Valid-row count of each wave's slab.

    rows [W, slots] int32 per-task read ∪ write state rows (-1 padded);
    levels [W] int32 wave level per task (-1 = invalid/executed). Returns
    [n_waves_max] int32. Unlike ``window_halo``, -1 row slots are dropped
    — the slab layout is allowed to be tighter than the static halo.
    """
    key, ok = _slab_keys(rows, levels, n_waves_max)
    return _counts(key, ok, n_waves_max)


def _slab_keys(rows, levels, n_waves_max):
    """Per row slot: its wave (n_waves_max for a dropped slot), and
    whether it is kept."""
    slots = rows.shape[1]
    wave = levels.to(torch.int32)[:, None].expand(-1, slots).reshape(-1)
    ok = (rows.reshape(-1) >= 0) & (wave >= 0) & (wave < n_waves_max)
    return torch.where(ok, wave, n_waves_max), ok


def _counts(key, ok, n_waves_max):
    # a scatter-add, not bincount: bincount sizes its output from the
    # data's max, a host sync on the card
    counts = torch.zeros(n_waves_max + 1, dtype=torch.int32,
                         device=key.device)
    counts.scatter_add_(0, key.long(), ok.to(torch.int32))
    return counts[:n_waves_max]


def wave_halo_split(rows: torch.Tensor, levels: torch.Tensor, *,
                    n_waves_max: int, chunk: int,
                    n_chunks_max: int | None = None):
    """Partition a window's read ∪ write rows into per-wave chunked slabs.

    rows [W, slots] int32 (-1 padded), levels [W] int32 (-1 dropped —
    executed tasks of a draining window contribute nothing). Returns

      slabs       [n_chunks_max, chunk] int32, -1 padded: wave-major
                  chunk layout; wave w's rows fill chunks
                  [chunk_start[w], chunk_start[w+1]) contiguously, in
                  task-major slot order (a stable sort, as the
                  reference's),
      chunk_start [n_waves_max + 1] int32 cumulative chunk offsets
                  (an empty wave owns zero chunks -> a clean no-op).

    ``n_chunks_max`` defaults to the worst case
    ceil(W·slots / chunk) + n_waves_max (every wave pays at most one
    partially-filled chunk); rows whose wave is >= n_waves_max are
    dropped (an overlapped pair's next-window tasks beyond the drain
    horizon — they are re-split after rebasing). Static shapes and no
    host sync: every rank derives the identical layout from replicated
    values.
    """
    w_tasks, slots = rows.shape
    if n_chunks_max is None:
        n_chunks_max = -(-(w_tasks * slots) // chunk) + n_waves_max
    with annotate("protocol.wave_halo_split", rows.device):
        flat = rows.reshape(-1)
        key, ok = _slab_keys(rows, levels, n_waves_max)
        counts = _counts(key, ok, n_waves_max)
        zero = counts.new_zeros(1)
        chunk_start = torch.cat([zero, torch.cumsum(
            (counts + chunk - 1) // chunk, 0).to(torch.int32)])
        starts = torch.cat([zero, torch.cumsum(counts, 0).to(torch.int32)])
        # rank of each kept entry within its wave: a stable sort groups
        # waves contiguously (the sentinel n_waves_max sinks dropped
        # entries past the real segments), rank = position - segment start
        order = torch.argsort(key, stable=True)
        k_sorted, r_sorted = key[order].long(), flat[order]
        rank = (torch.arange(k_sorted.shape[0], dtype=torch.int32,
                             device=rows.device) - starts[k_sorted])
        # flat position in the chunked layout: wave w's chunk range, row rank
        pos = chunk_start[k_sorted] * chunk + rank
        total = n_chunks_max * chunk
        keep = (k_sorted < n_waves_max) & (pos < total)
        slabs = torch.full((total + 1,), -1, dtype=torch.int32,
                           device=rows.device)
        slabs.index_put_((torch.where(keep, pos, total).long(),),
                         r_sorted.to(torch.int32))
        return slabs[:total].reshape(n_chunks_max, chunk), chunk_start


def wave_halo_gather(local, slabs: torch.Tensor, c0: int, c1: int, *,
                     agents: AgentGroup):
    """Gather chunks [c0, c1) of a per-wave slab layout — a wave's whole
    chunk range, where the reference gathers one chunk a call — from
    row-sharded leaves in one collective: returns (rows
    [(c1 - c0)·chunk, ...], slab [(c1 - c0)·chunk]) — the slab is handed
    back so the caller can scatter the gathered rows without
    re-indexing. An empty range, or zero-width chunks, issues no
    collective, matching ``halo_gather``. To a cost recorder the call is
    the reference's chunk loop (one depth deeper): ``c1 - c0`` units of
    one chunk each.
    """
    with annotate("protocol.wave_halo_gather", agents.device), \
            cost_loop(current_recorder()):
        slab = slabs[c0:c1].reshape(-1)
        return halo_gather(local, slab, agents, units=c1 - c0), slab


# --------------------------------------------------------------------------
# LM training/serving mesh
#
# Port of the reference's LM rules (DESIGN.md §8 there):
#
#   * batch                      -> (pod, data)          [DP]
#   * attention heads / kv heads -> model                [TP] when divisible
#   * MLP hidden, vocab          -> model                [TP] when divisible
#   * experts                    -> the data axes, else model  [EP]
#   * optimizer moments          -> param spec + the data axes on the
#                                   largest still-replicated dim [ZeRO-1]
#
# Head-structured weights are stored flattened ([D, H·hd]); they shard only
# on whole-head boundaries, so the rules consult the config
# (n_heads % model_size) rather than the raw dim size. Only divisible dims
# are sharded: anything else is replicated, so no placement is uneven.
#
# A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (ranks behind
# it) or a ``LogicalMesh`` (only a shape and axis names: the production
# meshes of the dry run). The rules read only the axis names and sizes, so
# both give the same specs. A spec is the port's ``PartitionSpec``: a tuple
# of None, an axis name or a tuple of axis names, per tensor dim, the values
# the reference's rules return.


class PartitionSpec(tuple):
    """Per tensor dim: None (replicated), an axis name, or a tuple of axis
    names (major to minor). Compares equal to the reference's spec of the
    same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class LogicalMesh:
    """A mesh with no ranks behind it: its shape and axis names."""

    shape: tuple
    axis_names: tuple

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def mesh_axes(mesh) -> dict[str, int]:
    """axis name -> size, of a ``LogicalMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, LogicalMesh):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _axis_size(mesh, name: str) -> int:
    return mesh_axes(mesh).get(name, 1)


def data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh_axes(mesh))


def data_size(mesh) -> int:
    return math.prod(_axis_size(mesh, a) for a in data_axes(mesh))


def _divisible(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _one(axes: tuple):
    """The spec entry of a group of axes: the name alone, or the tuple."""
    return axes if len(axes) > 1 else axes[0]


def param_pspec(path: str, leaf, cfg, mesh) -> P:
    """PartitionSpec for one parameter leaf (path: the reference's
    ``/``-joined names; ``leaf.shape`` the reference's, the stacked layer
    axis included: the rules index from the end)."""
    model = _axis_size(mesh, "model")
    shape = leaf.shape

    def heads_ok(n):
        return _divisible(n, model)

    if getattr(cfg, "layout", "tp") == "dp":
        # pure-DP layout: params replicated; the model axis carries extra
        # batch shards instead of TP
        return P(*([None] * len(shape)))

    spec: list = [None] * len(shape)

    def set_last(ax):
        spec[-1] = ax

    def set_first_matrix_dim(ax):
        if len(shape) >= 2:
            spec[-2] = ax

    def experts(gate_up: bool):
        # [.., E, D, Fe] / [.., E, Fe, D]: experts over the data axes
        # (FSDP-style ownership), else over model; the TP dim differs per
        # impl: shard_map contracts over D, dense shards the hidden Fe
        daxes = data_axes(mesh)
        if daxes and _divisible(cfg.moe.n_experts, data_size(mesh)):
            spec[-3] = _one(daxes)
        elif _divisible(cfg.moe.n_experts, model):
            spec[-3] = "model"
        if spec[-3] != "model":
            if getattr(cfg, "moe_impl", "dense").startswith("shard_map"):
                if _divisible(cfg.d_model, model):
                    spec[-2 if gate_up else -1] = "model"
            elif _divisible(cfg.moe.d_expert, model):
                spec[-1 if gate_up else -2] = "model"

    if re.search(r"embed/table$", path):
        if _divisible(cfg.vocab, model):
            spec[-2] = "model"                      # vocab-parallel rows
    elif re.search(r"lm_head/w$", path):
        if _divisible(cfg.vocab, model):
            set_last("model")
    elif re.search(r"experts/(w_gate|w_up)$", path):
        experts(True)
    elif re.search(r"experts/w_out$", path):
        experts(False)
    elif re.search(r"(attn|xattn)/wq/[wb]$", path):
        if heads_ok(cfg.n_heads):
            set_last("model")
    elif re.search(r"(attn|xattn)/w[kv]/[wb]$", path):
        if heads_ok(cfg.n_kv_heads):
            set_last("model")
    elif re.search(r"(attn|xattn)/wo/w$", path):
        if heads_ok(cfg.n_heads):
            set_first_matrix_dim("model")
    elif re.search(r"(mlp|dense_mlp)/(w_gate|w_up)/w$", path):
        if _divisible(cfg.d_ff, model):
            set_last("model")
    elif re.search(r"(mlp|dense_mlp)/w_out/w$", path):
        if _divisible(cfg.d_ff, model):
            set_first_matrix_dim("model")
    elif re.search(r"rwkv/tm/w[rkvg]/w$", path):
        if _divisible(cfg.d_model, model) and heads_ok(
                cfg.d_model // cfg.hd):
            set_last("model")
    elif re.search(r"rwkv/tm/wo/w$", path):
        if _divisible(cfg.d_model, model) and heads_ok(
                cfg.d_model // cfg.hd):
            set_first_matrix_dim("model")
    elif re.search(r"rwkv/cm/wk/w$", path):
        if _divisible(cfg.d_ff, model):
            set_last("model")
    elif re.search(r"rwkv/cm/wv/w$", path):
        if _divisible(cfg.d_ff, model):
            set_first_matrix_dim("model")
    elif re.search(r"ssm/(w_x|w_z|w_b|w_c|w_dt)/w$", path) and cfg.ssm:
        if heads_ok(cfg.ssm.n_heads or cfg.d_model // cfg.ssm.head_dim):
            set_last("model")
    elif re.search(r"ssm/w_out/w$", path) and cfg.ssm:
        if heads_ok(cfg.ssm.n_heads or cfg.d_model // cfg.ssm.head_dim):
            set_first_matrix_dim("model")
    # everything else (norms, mus, router, biases, prefix): replicated
    return P(*spec)


def zero1_pspec(path: str, leaf, cfg, mesh) -> P:
    """Optimizer-moment spec: the param spec plus the data axes on the
    largest still-unsharded, divisible dim (ZeRO-1 state partitioning)."""
    base = param_pspec(path, leaf, cfg, mesh)
    spec = list(base) + [None] * (len(leaf.shape) - len(base))
    daxes = data_axes(mesh)
    if getattr(cfg, "layout", "tp") == "dp" and "model" in mesh_axes(mesh):
        daxes = daxes + ("model",)   # ZeRO over every axis in pure-DP
    dsize = math.prod(_axis_size(mesh, a) for a in daxes) if daxes else 1
    if dsize <= 1 or not daxes:
        return P(*spec)
    used = set()
    for s in spec:
        used.update(s if isinstance(s, tuple) else (s,))
    if any(a in used for a in daxes):    # e.g. 2-D-sharded experts
        return P(*spec)
    cand = [(dim, i) for i, dim in enumerate(leaf.shape)
            if spec[i] is None and dim % dsize == 0]
    if cand:
        _, i = max(cand)
        spec[i] = _one(daxes)
    return P(*spec)


def batch_pspec(mesh, leaf_shape, *, batch_size: int,
                layout: str = "tp") -> P:
    """Batch inputs: leading dim over (pod, data); the "dp" layout also
    folds the model axis into the batch (pure data parallelism)."""
    candidates = [data_axes(mesh)]
    if layout == "dp" and "model" in mesh_axes(mesh):
        candidates.insert(0, data_axes(mesh) + ("model",))
    for daxes in candidates:
        dsize = math.prod(_axis_size(mesh, a) for a in daxes) if daxes else 1
        if daxes and batch_size % dsize == 0:
            return P(_one(daxes), *([None] * (len(leaf_shape) - 1)))
    return P(*([None] * len(leaf_shape)))


def states_spec(path: str, shape, cfg, mesh, *, global_batch: int) -> P:
    """Decode/serving state spec: KV caches [L, B, Hkv, S, hd] get
    batch->data and kv_heads->model (whole heads only; else the sequence
    with ``seq_shard_cache``); SSM states [L, B, H, P, N] and RWKV
    ``tm/s`` [L, B, H, hd, hd] batch->data, heads->model; ``last``,
    ``kpos``/``length``, ``pos`` and ``enc_out`` batch->data; the rest
    replicated. The states keep the stacked layer axis in both
    packages."""
    model = _axis_size(mesh, "model")
    daxes = data_axes(mesh)
    batch_ax = _one(daxes) if daxes else None
    shard_batch = batch_ax is not None and global_batch % data_size(mesh) == 0
    spec: list = [None] * len(shape)
    if re.search(r"kv/(k|v)$", path) and len(shape) == 5:
        if shard_batch:
            spec[1] = batch_ax
        if _divisible(cfg.n_kv_heads, model):
            spec[2] = "model"
        elif getattr(cfg, "seq_shard_cache", False) \
                and _divisible(shape[3], model):
            spec[3] = "model"
    elif re.search(r"kv/(kpos|length)$", path):
        if shard_batch and len(shape) >= 2:
            spec[1] = batch_ax
    elif path == "pos" and len(shape) == 1:
        if shard_batch:
            spec[0] = batch_ax
    elif re.search(r"/ssm$", path) and len(shape) == 5:
        if shard_batch:
            spec[1] = batch_ax
        if _divisible(cfg.ssm.n_heads or cfg.d_model // cfg.ssm.head_dim,
                      model):
            spec[2] = "model"
    elif re.search(r"tm/s$", path) and len(shape) == 5:
        if shard_batch:
            spec[1] = batch_ax
        if _divisible(cfg.d_model // cfg.hd, model):
            spec[2] = "model"
    elif re.search(r"(tm|cm)/last$", path) and len(shape) == 4:
        if shard_batch:
            spec[1] = batch_ax
    elif re.search(r"enc_out$", path) and len(shape) == 3:
        if shard_batch:
            spec[0] = batch_ax
    return P(*spec)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``). A spec one
    entry longer than the tensor it places is a stacked leaf's (the
    reference's ``[L, ...]``): its first entry, the layer axis, is dropped
    for the port's per-layer tensor, whose layer is then whole on every
    rank of that axis."""

    mesh: Any
    spec: P

    def local_spec(self, ndim: int) -> P:
        if len(self.spec) == ndim + 1:
            return P(*self.spec[1:])
        if len(self.spec) != ndim:
            raise ValueError(f"spec {self.spec} for a {ndim}-d tensor")
        return self.spec

    def placements(self, ndim: int) -> tuple:
        """DTensor placements on the ``DeviceMesh``, one per mesh dim."""
        return spec_placements(self.local_spec(ndim), self.mesh)

    def shard_shape(self, shape) -> tuple:
        """The shape each rank holds of a tensor of ``shape``."""
        sizes = mesh_axes(self.mesh)
        out = []
        for dim, entry in zip(shape, self.local_spec(len(shape))):
            k = math.prod(sizes[a] for a in _names(entry))
            if dim % k:
                raise ValueError(f"dim {dim} does not split {k} ways "
                                 f"({self.spec})")
            out.append(dim // k)
        return tuple(out)


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_placements(spec: P, mesh) -> tuple:
    """A spec -> DTensor ``Shard``/``Replicate`` placements, one per mesh
    dim. A tensor dim over several axes (``("pod", "data")``) is
    ``Shard(i)`` on each of them; DTensor splits such a dim over its mesh
    dims left to right, major first, which is the reference's order when
    the spec names the axes in the mesh's order (the rules always do)."""
    from torch.distributed.tensor import Replicate, Shard

    order = list(mesh_axes(mesh))
    out = [Replicate() for _ in order]
    for i, entry in enumerate(spec):
        names = _names(entry)
        if [order.index(a) for a in names] != sorted(
                order.index(a) for a in names):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"axis order {order}")
        for a in names:
            out[order.index(a)] = Shard(i)
    return tuple(out)


def params_shardings(params, cfg, mesh) -> dict[str, NamedSharding]:
    """{port leaf name: NamedSharding} of a parameter tree: each leaf's
    spec is its reference leaf's (stacked, for a layer's leaf)."""
    return tree_map_with_path_str(
        lambda path, leaf: NamedSharding(
            mesh, param_pspec(path, leaf, cfg, mesh)),
        params, stacked=True)


def opt_state_shardings(params, cfg, mesh) -> dict[str, NamedSharding]:
    """Moment shardings (ZeRO-1) of a tree shaped as the parameters."""
    return tree_map_with_path_str(
        lambda path, leaf: NamedSharding(
            mesh, zero1_pspec(path, leaf, cfg, mesh)),
        params, stacked=True)


def batch_shardings(batch: dict, mesh, *, layout: str = "tp"
                    ) -> dict[str, NamedSharding]:
    def f(leaf):
        b = leaf.shape[0] if leaf.dim() else 1
        return NamedSharding(mesh, batch_pspec(
            mesh, leaf.shape, batch_size=b, layout=layout))

    return {k: f(v) for k, v in batch.items()}


def states_shardings(states, cfg, mesh, *, global_batch: int
                     ) -> dict[str, NamedSharding]:
    """{port leaf name: NamedSharding} of a serving state tree
    (``Model.init_states``'s, stacked ``[L, ...]`` leaves)."""
    return tree_map_with_path_str(
        lambda path, leaf: NamedSharding(mesh, states_spec(
            path, leaf.shape, cfg, mesh, global_batch=global_batch)),
        states)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


# --------------------------------------------------------------------------
# placing tensors on a DeviceMesh


def distribute(t: torch.Tensor, sharding: NamedSharding):
    """A DTensor of ``t`` placed by ``sharding``. Every rank holds the same
    full ``t`` (drawn from one seed, or read from one checkpoint) and keeps
    its own shard of it: no collective."""
    from torch.distributed.tensor import distribute_tensor

    t = t.detach()
    if t.is_inference():
        # serving states are made under inference_mode; a DTensor over an
        # inference tensor cannot be viewed (its version counter)
        t = t.clone()
    return distribute_tensor(t, sharding.mesh,
                             sharding.placements(t.dim()), src_data_rank=None)


@torch.no_grad()
def place_module(module: torch.nn.Module, shardings: dict) -> None:
    """Replace each parameter of ``module`` in place by a DTensor placed by
    ``shardings[name]``; ``requires_grad`` is kept."""
    for name, sh in shardings.items():
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        p = getattr(mod, leaf)
        mod._parameters[leaf] = torch.nn.Parameter(
            distribute(p.data, sh), requires_grad=p.requires_grad)


def place(tree, shardings: dict, prefix: str = ""):
    """A copy of a tree of tensors (dicts, lists, NamedTuples) with each
    leaf ``name`` placed by ``shardings[name]`` (names as
    ``utils.pytree.named_leaves``'s)."""
    if isinstance(tree, torch.Tensor):
        return distribute(tree, shardings[prefix[:-1]])
    if hasattr(tree, "_fields"):
        return type(tree)(*(place(getattr(tree, f), shardings,
                                  f"{prefix}{f}.") for f in tree._fields))
    if isinstance(tree, dict):
        return {k: place(v, shardings, f"{prefix}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [place(v, shardings, f"{prefix}{i}.")
                for i, v in enumerate(tree)]
    return tree

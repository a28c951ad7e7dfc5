"""Multi-rank wavefront engine: waves sharded over the agent axis.

Port of ``repro/engine/sharded.py`` on ``torch.distributed``. Every rank
holds one contiguous row block of every state leaf (``AgentGroup``,
``distributed/sharding.py``) and runs the same schedule from the same
key — ``create_tasks``, the conflict and levels kernels and, with
overlap, the block kernel and the carry — so window-local objects are
replicated without communication, as in the reference. One engine body
serves a *ladder* of communication layouts, decided per run from the
model's row contracts and the schedule shape (most to least specialized
— each rung degrades to the next when it cannot win):

**Per-wave halo split** (``sharded``, the default top rung). Wave levels
are known at schedule time, so the window's halo (the read ∪ write state
rows of its tasks) is split into per-wave slabs laid out wave-major in
fixed-width chunks (``wave_halo_split``): wave w ships only its chunk
range, ceil(rows_w / chunk)·chunk ≈ rows_w rows, ≈ one window halo per
window instead of one per wave. The reference issues one collective per
chunk inside a device loop; here ``chunk_start`` reaches the host in the
same copy as the window's wave count (the port's one sync per window)
and a wave's whole chunk range travels in **one** collective — the same
rows, so the comm ledger and every comm stat are the reference's. An
empty wave issues none.

**Window halo** (``sharded_window_halo``, the monolithic middle rung).
From the model's ``task_read_agents`` / ``task_write_agents`` contracts
the engine derives the window's halo, padded to the static width
W·(nr+nw), and every wave

  1. gathers the halo rows: each row has a unique owner rank; owners
     contribute, one ``all_reduce(SUM)`` delivers the rows everywhere —
     O(halo) values per rank instead of the all_gather's O(N);
  2. scatters them into a zero scratch of n rows and refreshes the local
     row block from the authoritative local shard (no comm) — every row
     an owned task can read is now current; rows outside halo ∪ local
     block stay zeros and are provably never read;
  3. restricts the wave mask to *owned* tasks (a task executes on every
     rank whose row block contains one of its write targets) and runs
     the model's ``execute_wave`` on the scratch;
  4. keeps only the local row block of the result — writes land on
     their owners, so no write scatter is communicated at all.

The split rung replaces steps 1-2 with its per-wave slab gather; steps
3-4 are identical, so bit-exactness is untouched.

**Replicated all_gather** (``sharded_replicated``, the bottom rung): per
wave, all-gather the row blocks into the full state and execute on it.
Models that do not declare both row contracts route here automatically,
as does any monolithic run whose halo would not beat the full state
(halo width >= N; the split rung only needs a chunk narrower than N).

**Cross-window overlap** (``overlap=True`` / ``sharded_overlap``): window
k+1's head waves execute fused with window k's tail (``WindowedEngine``).
The split rung re-splits the pair's rows by the fused levels at every
boundary; the monolithic rung gathers the *pair halo* (both windows'
rows, width 2·W·(nr+nw)) and decides halo-vs-full on that doubled width.
Each fused wave executes window k's owned tasks at that level, then
window k+1's on the same scratch — legal because the carry frontier
guarantees a fused wave never holds conflicting tasks.

Process model. The caller initializes ``torch.distributed`` (as
``torchrun`` users do) and passes ``group=`` or leaves the default group
to be found; without one the engine is a world of one that issues no
collective (the reference's one-device mesh). ``run`` takes the full
state on every rank and returns it on every rank (the row blocks are
all-gathered at the end, as the reference returns its global array).
Collectives run on the group's own streams, ordered after the ops that
produced their inputs (``ProcessGroupNCCL`` waits on the current
stream and keeps its inputs alive until it has read them).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.sharding import (
    agent_group,
    all_gather_rows,
    halo_gather,
    halo_scatter,
    pair_halo,
    wave_halo_gather,
    wave_halo_split,
    window_halo,
)
from repro_torch.engine.base import WindowedEngine, register_engine
from repro_torch.obs.costs import current_recorder, loop as cost_loop
from repro_torch.obs.profiler import annotate


@register_engine
class ShardedEngine(WindowedEngine):
    name = "sharded"

    #: None = probe the model for the halo contracts; False = always
    #: replicate (the ``sharded_replicated`` registry entry).
    halo: bool | None = None

    #: per-wave halo splitting — the top rung of the comm ladder. None =
    #: on whenever the halo contracts are available; False pins the
    #: monolithic window/pair halo (the ``sharded_window_halo`` entry).
    split: bool | None = None

    def __init__(self, model, *, window: int = 256, strict: bool = True,
                 group=None, device=None, halo: bool | None = None,
                 split: bool | None = None, chunk: int = 16,
                 overlap: bool | None = None):
        agents = agent_group(group, device)
        super().__init__(model, window=window, strict=strict,
                         overlap=overlap, device=agents.device)
        self.agents = agents
        self.n_devices = agents.world_size
        self._built_for: int | None = None  # n_agents the layout is for
        self._win_comm: list = []           # per-window comm ledger
        if halo is not None:
            self.halo = halo
        if split is not None:
            self.split = split
        #: slab chunk width (rows) for the split rung — the shipped
        #: padding; the reference's collective count per chunk
        self.chunk = int(chunk)
        if self.chunk < 1:
            raise ValueError("chunk must be a positive row count")
        self._halo_slots = 0
        if self.halo is None or self.halo:
            # one-shot probe: the halo layout needs both row contracts.
            # Its key is key(0) made on the device: a host-built key is a
            # blocking copy, a host sync
            key0 = torch.zeros(2, dtype=torch.int64, device=self.device)
            probe = model.create_tasks(key0, 0, 1)
            reads = model.task_read_agents(probe)
            writes = model.task_write_agents(probe)
            if self.halo is None:
                self.halo = reads is not None and writes is not None
            elif reads is None or writes is None:
                raise ValueError(
                    f"halo=True needs {type(model).__name__} to implement "
                    "both task_read_agents and task_write_agents; use the "
                    "'sharded_replicated' engine (or halo=None auto-probe) "
                    "for models without the row contracts")
            if self.halo:
                self._halo_slots = reads.shape[-1] + writes.shape[-1]

    # --------------------------------------------------------- schedule
    def _halo_parts(self, recipes):
        """(writes, monolithic halo, per-task rows) — the last two None
        without the row contracts."""
        writes = self.model.task_write_agents(recipes)
        if not self.halo:
            return writes, None, None
        reads = self.model.task_read_agents(recipes)
        return (writes, window_halo(reads, writes),
                torch.cat([reads, writes], dim=1))

    def _schedule(self, base_key, start: int, count: int):
        recipes, _, levels = super()._schedule(base_key, start, count)
        return (recipes, levels) + self._halo_parts(recipes)

    def _schedule_ov(self, base_key, start: int, count: int):
        recipes, valid, conf = self._schedule_window_ov(base_key, start,
                                                        count)
        return recipes, valid, conf, self._halo_parts(recipes)

    # ------------------------------------------------------------ build
    def _build(self, n_agents: int) -> None:
        """Lay the agent axis out over ``n_agents`` and take the ladder's
        decisions for that count."""
        if self._built_for == n_agents:
            return
        self.agents = self.agents.for_agents(n_agents)
        n_pad = self.agents.n_pad
        halo_width = self.window * self._halo_slots
        # monolithic fallback-rung decisions: a degenerate halo (>= full
        # state) means replication ships fewer bytes. Barrier/drain
        # windows decide on the single-window width, fused pairs on the
        # doubled one (a window size whose single halo wins can lose once
        # doubled). The split rung ships ~one halo per *window*, so it
        # only degrades when a single chunk cannot beat the state.
        self._use_halo = bool(self.halo) and halo_width < n_agents
        self._use_halo_pair = bool(self.halo) and 2 * halo_width < n_agents
        self._use_split = (bool(self.halo) and self.split is not False
                           and self.chunk < n_agents)
        self._n_agents, self._n_pad = n_agents, n_pad
        self._shard_n = self.agents.shard_n
        self._halo_width = halo_width
        # the monolithic per-wave reference the split is measured against
        # (the mode that dominates the run: pair width for overlapped
        # runs, plain window halo otherwise; padded N when the monolithic
        # ladder itself would replicate)
        if self.overlap:
            self._gather_rows = 2 * halo_width if self._use_halo_pair \
                else n_pad
        else:
            self._gather_rows = halo_width if self._use_halo else n_pad
        self._built_for = n_agents

    # ------------------------------------------------------- state hooks
    def _prepare_state(self, state):
        if not state:
            raise ValueError("empty state")
        n = next(iter(state.values())).shape[0]
        if any(x.shape[0] != n for x in state.values()):
            raise ValueError(
                "the sharded engine expects every state leaf to lead with "
                "the agent axis; got shapes "
                f"{[tuple(x.shape) for x in state.values()]}")
        self._build(n)
        # per-agent-row bytes across leaves -> comm accounting for stats
        self._row_bytes = sum(x.element_size() * x.numel() // n
                              for x in state.values())
        self._full_bytes = self._n_pad * self._row_bytes
        self._win_comm = []
        self.agents.collectives = self.agents.comm_bytes = 0
        lo = self.agents.lo
        return self._padded({k: x[lo:lo + self._shard_n]
                             for k, x in state.items()})

    def _padded(self, block: dict) -> dict:
        """A row block cut at n, padded with zero rows to shard_n."""
        short = self._shard_n - next(iter(block.values())).shape[0]
        if not short:
            return block
        return {k: torch.cat([x, x.new_zeros((short,) + x.shape[1:])])
                for k, x in block.items()}

    def _finalize_state(self, local):
        if self.agents.group is None:
            return {k: x[:self._n_agents] for k, x in local.items()}
        full = all_gather_rows(local, self.agents, count=False)
        return {k: x[:self._n_agents] for k, x in full.items()}

    # ------------------------------------------------------ wave views
    def _scratch(self, local, halo=None, gathered=None):
        """Every row the wave's owned tasks may read, fresh: the gathered
        halo rows scattered into a zero scratch of n rows, with this
        rank's block refreshed from the authoritative local shard (so
        the end-of-wave slice keeps unwritten rows exact)."""
        n, lo = self._n_agents, self.agents.lo
        hi = min(lo + self._shard_n, n)
        out = {}
        for k, x in local.items():
            s = x.new_zeros((n,) + x.shape[1:])
            if halo is not None:
                s = halo_scatter(s, halo, gathered[k])
            if hi > lo:
                s[lo:hi] = x[:hi - lo]
            out[k] = s
        return out

    def _full_view(self, local, w):
        """The replicated rung: the whole state, all-gathered."""
        n = self._n_agents
        return {k: x[:n] for k, x in
                all_gather_rows(local, self.agents).items()}

    def _keep_local(self, new):
        lo = self.agents.lo
        return self._padded({k: x[lo:lo + self._shard_n]
                             for k, x in new.items()})

    def _owned(self, write_agents):
        """Tasks this rank executes: a write target in its row block
        (all tasks without the write contract)."""
        if write_agents is None:
            return None
        lo = self.agents.lo
        return ((write_agents >= lo)
                & (write_agents < lo + self._shard_n)).any(dim=-1)

    def _waves(self, local, parts, n_waves: int, view):
        """Run ``n_waves`` waves: per wave, ``view(local, w)`` builds the
        scratch and each part (recipes, levels, write targets) executes
        its owned tasks at level w on it, in order; the local block of
        the result is kept."""
        parts = [(rec, lv, self._owned(wa)) for rec, lv, wa in parts]
        with cost_loop(current_recorder()):
            for w in range(n_waves):
                with annotate("protocol.wave", self.device):
                    full = view(local, w)
                    for rec, lv, owned in parts:
                        mask = lv == w
                        if owned is not None:
                            mask = mask & owned
                        full = self.model.execute_wave(full, rec, mask)
                    local = self._keep_local(full)
        return local

    def _run_split(self, local, parts, rows, levels, lv_count):
        """The split rung over one window (or fused pair): slabs by
        ``levels``, the wave count from ``lv_count``; both reach the host
        in one copy — the window's one sync. Each wave gathers its whole
        chunk range in one collective; an empty range gathers nothing."""
        chunk = self.chunk
        slabs, chunk_start = wave_halo_split(rows, levels,
                                             n_waves_max=self.window,
                                             chunk=chunk)
        host = torch.cat([(lv_count.max() + 1).reshape(1).to(torch.int32),
                          chunk_start]).tolist()
        n_waves, cs = host[0], host[1:]
        # rows actually gathered this window (every executed wave's
        # chunk range) — the comm ledger entry for the stats
        self._win_comm.append(("split", cs[n_waves] * chunk, n_waves))

        def view(loc, w):
            c0, c1 = cs[w], cs[w + 1]
            if c1 == c0:
                return self._scratch(loc)
            g, slab = wave_halo_gather(loc, slabs, c0, c1,
                                       agents=self.agents)
            return self._scratch(loc, slab, g)

        return self._waves(local, parts, n_waves, view), n_waves

    def _run_mono(self, local, parts, halo, n_waves: int, use: bool,
                  kind: str, width: int):
        """The monolithic rungs: the whole ``halo`` every wave when
        ``use``, else the full state (ledger entry ``kind``/``width``)."""
        if use:
            self._win_comm.append((kind, width, n_waves))

            def view(loc, w):
                return self._scratch(loc, halo,
                                     halo_gather(loc, halo, self.agents))
        else:
            self._win_comm.append(("full", self._n_pad, n_waves))
            view = self._full_view
        return self._waves(local, parts, n_waves, view)

    # -------------------------------------------------------- executors
    def _execute(self, local, sched):
        recipes, levels, write_agents, halo, rows = sched
        parts = [(recipes, levels, write_agents)]
        with annotate("protocol.execute_window", self.device):
            if self._use_split and rows is not None:
                return self._run_split(local, parts, rows, levels, levels)
            n_waves = int(levels.max()) + 1  # the window's one host sync
            local = self._run_mono(local, parts, halo, n_waves,
                                   self._use_halo, "halo", self._halo_width)
        return local, n_waves

    def _execute_pair(self, local, cur, lv_a, nxt, lv_b):
        """Fused drain of window k (``cur``) with window k+1 (``nxt``)
        riding along; returns (local, n_waves, lv_b rebased)."""
        rec_a, _, _, (wa_a, halo_a, rows_a) = cur
        rec_b, _, _, (wa_b, halo_b, rows_b) = nxt
        parts = [(rec_a, lv_a, wa_a), (rec_b, lv_b, wa_b)]
        with annotate("protocol.execute_pair", self.device):
            if self._use_split and rows_a is not None:
                # re-split at every boundary: the carry re-leveling moves
                # window b's tasks between fused waves, and rebasing
                # retires window a's drained tasks (level -1 rows drop)
                local, n_waves = self._run_split(
                    local, parts, torch.cat([rows_a, rows_b]),
                    torch.cat([lv_a, lv_b]), lv_a)
            else:
                n_waves = int(lv_a.max()) + 1  # the window's one host sync
                halo = (pair_halo(halo_a, halo_b) if halo_a is not None
                        else None)
                local = self._run_mono(local, parts, halo, n_waves,
                                       self._use_halo_pair, "pair",
                                       2 * self._halo_width)
        # rebase the next window onto the new level clock; executed (and
        # invalid) tasks drop to -1
        lv_b = torch.where(lv_b >= n_waves, lv_b - n_waves, -1)
        return local, n_waves, lv_b

    def _execute_drain(self, local, cur, lv):
        # partnerless drain (last / only window): the barrier executor,
        # re-split by the current (possibly rebased) levels — drained
        # tasks carry level -1 and gather nothing
        wa, halo, rows = cur[3]
        return self._execute(local, (cur[0], lv, wa, halo, rows))

    # ------------------------------------------------------------ stats
    def _extend_stats(self, stats: dict) -> dict:
        stats["n_devices"] = self.n_devices
        # the comm ledger holds one entry per executed window / fused
        # drain: "split" entries carry the window's total shipped rows
        # (the chunk ranges of its executed waves), monolithic entries
        # the static per-wave width
        ledger = self._win_comm
        total_rows = sum(r if kind == "split" else r * w
                         for kind, r, w in ledger)
        waves = max(int(stats["total_waves"]), 1)
        rb = self._row_bytes
        mean_rows = total_rows / waves
        split_used = any(kind == "split" for kind, _, _ in ledger)
        stats["halo"] = any(kind in ("split", "halo", "pair")
                            for kind, _, _ in ledger)
        stats["halo_split"] = split_used
        # per-window layout composition — e.g. an overlapped run whose
        # pair halo tripped the width guard still drains its final
        # window through the single-window halo: {"full": 4, "halo": 1}
        modes: dict = {}
        for kind, _, _ in ledger:
            modes[kind] = modes.get(kind, 0) + 1
        stats["comm_modes"] = modes
        # rows/bytes actually delivered to each rank per wave (mean over
        # executed waves — the split rung varies per wave), plus the
        # monolithic window/pair-halo reference it is measured against
        stats["per_wave_gather_rows"] = int(round(mean_rows))
        stats["per_wave_comm_bytes"] = int(round(mean_rows * rb))
        stats["full_state_bytes"] = int(self._full_bytes)
        stats["comm_bytes_total"] = int(total_rows * rb)
        stats["per_wave_split_rows"] = (round(mean_rows, 2) if split_used
                                        else None)
        if self.halo:
            stats["window_halo_rows"] = int(self._gather_rows)
            stats["window_halo_bytes"] = int(self._gather_rows * rb)
            stats["comm_reduction_vs_window_halo"] = (
                round(stats["window_halo_bytes"]
                      / stats["per_wave_comm_bytes"], 2)
                if stats["per_wave_comm_bytes"] else None)
        else:
            stats["window_halo_rows"] = None
            stats["window_halo_bytes"] = None
            stats["comm_reduction_vs_window_halo"] = None
        return stats

    # ------------------------------------------------------ compiled costs
    def _cost_targets(self, base_key, state):
        sched = self._schedule(base_key, 0, self.window)
        name = ("execute_split" if self._use_split and sched[4] is not None
                else "execute_window")
        return [(name, self._execute, (state, sched))]

    def comm_iteration_counts(self, stats: dict) -> dict[int, int]:
        """Executed loop iterations per nesting depth, from the comm
        ledger of the run that produced ``stats``: depth 1 is the wave
        loop (total executed waves), depth 2 the reference's chunk loop
        nested inside it (total chunk gathers = shipped rows / chunk; the
        port ships a wave's chunks in one collective). Read it before
        ``compiled_costs``, which re-prepares the state (a reset)."""
        chunk_iters = sum(r // self.chunk for kind, r, _ in self._win_comm
                          if kind == "split")
        return {1: int(stats["total_waves"]), 2: chunk_iters}

    # ------------------------------------------------------------ tracing
    # Reached only with a tracer installed (repro_torch.obs) — the comm
    # ledger entry appended by the window's executor names the rung, and
    # the schedule's replicated level/row/write-target tensors reproduce
    # the per-wave shipped volume host-side (the split math below mirrors
    # ``wave_halo_split``: valid row slots per wave, ceil'd to chunks).

    _RUNG_NAMES = {"split": "split", "halo": "window_halo",
                   "pair": "pair_halo", "full": "full_state"}

    def _trace_parts(self, sched, levels=None):
        if levels is None:
            _, lv, wa, _, rows = sched          # barrier schedule
        else:
            lv = levels                          # overlapped: re-leveled
            wa, _, rows = sched[3]
        return lv, wa, rows

    def _trace_execute_args(self) -> dict:
        if not self._win_comm:
            return {}
        kind, _, _ = self._win_comm[-1]
        return {"rung": self._RUNG_NAMES[kind], "n_devices": self.n_devices}

    def _trace_wave_comm(self, np_parts, n_waves: int):
        if not self._win_comm:
            return None
        kind = self._win_comm[-1][0]
        rung = self._RUNG_NAMES[kind]
        if kind == "split":
            per_wave = np.zeros(n_waves, np.int64)
            for lv, _, rows in np_parts:
                if rows is None:
                    continue
                ok = (lv >= 0) & (lv < n_waves)
                np.add.at(per_wave, lv[ok], (rows[ok] >= 0).sum(axis=1))
            per_wave = -(-per_wave // self.chunk) * self.chunk
        else:
            width = {"halo": self._halo_width,
                     "pair": 2 * self._halo_width,
                     "full": self._n_pad}[kind]
            per_wave = np.full(n_waves, width, np.int64)
        # per-rank owned-task counts (a task runs on every rank whose row
        # block holds one of its write targets) -> load imbalance
        owned = np.zeros((n_waves, self.n_devices), np.int64)
        for lv, wa, _ in np_parts:
            if wa is None:
                continue
            dev = np.where(wa >= 0, wa // self._shard_n, -1)
            for i in np.nonzero((lv >= 0) & (lv < n_waves))[0]:
                devs = np.unique(dev[i])
                owned[lv[i], devs[devs >= 0]] += 1
        rb = self._row_bytes
        return [{"rung": rung, "rows": int(r), "bytes": int(r) * rb,
                 "owned": owned[w].tolist()}
                for w, r in enumerate(per_wave)]


@register_engine
class ShardedWindowHaloEngine(ShardedEngine):
    """The monolithic window/pair-halo layout: the whole halo row list is
    gathered every wave. Kept as the registered middle rung of the comm
    ladder — and as the baseline the per-wave split's comm stats
    (``comm_reduction_vs_window_halo``) are measured against."""

    name = "sharded_window_halo"
    split = False


@register_engine
class ShardedReplicatedEngine(ShardedEngine):
    """The full-state layout, kept as an explicit registry fallback (and
    as the measurement baseline the halo engines' comm stats are
    compared against)."""

    name = "sharded_replicated"
    halo = False


@register_engine
class ShardedOverlapEngine(ShardedEngine):
    """``sharded`` with cross-window overlap on by default: fused tail/
    head waves with per-fused-wave slab gathers (pair-halo gather on the
    monolithic rung). The plain ``sharded`` engine stays the registered
    barrier fallback."""

    name = "sharded_overlap"
    default_overlap = True

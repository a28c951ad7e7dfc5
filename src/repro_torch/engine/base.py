"""Execution-engine interface and registry.

Port of ``repro/engine/base.py``. An *engine* binds a ``MABSModel`` to a
way of running its task chain: strictly sequentially (the oracle), by
vectorized waves on one device, or by waves sharded over the agent axis
of a process group. All engines consume the identical task stream
(``create_tasks`` keyed by the global chain index) and produce
bit-identical state under the strict hazard rule.

    from repro_torch.engine import make_engine
    eng = make_engine("wavefront", model, window=4096)   # on the card
    state, stats = eng.run(state, total_tasks, seed=0)

``WindowedEngine`` fixes the streaming structure: windows of W tasks, each
scheduled (conflict matrix + wave levels) and then executed wave by wave,
with a double-buffered window pipeline — window t+1's schedule is
enqueued before window t's waves, on the one stream that keeps the order.
With ``overlap`` on, the window boundary stops being a barrier (the
record carry-over, ``WindowedEngine._run_overlapped``).

Tracing (``repro_torch.obs.tracing``): every run loop reads
``current_tracer()`` once and, when it is None (the default), takes the
untraced branch of each step — no extra op and no host sync. With a
tracer installed, the ``run``/``schedule``/``boundary``/``execute``
spans of the reference are recorded, each fenced on its outputs, and
each window's execute span is subdivided into width-attributed ``wave``
spans. Either way the schedule, its creation, the boundary and the
record steps open ``protocol.*`` ranges (``obs.profiler.annotate``),
which a profiler records and an installed tracer keeps as layer spans.

Costs (``Engine.compiled_costs``, ``repro_torch.obs.costs``): the
reference lowers its window executors ahead of time and reads XLA's cost
and memory analyses and HLO collectives; the port runs the executor once
on clones of a prepared state and one window's schedule, and counts what
it executes. The loops and the collective call sites report to the
installed cost recorder only; with none installed they take no extra op
and no host sync.
"""
from __future__ import annotations

import abc
from contextlib import nullcontext
from typing import Any, Type

import numpy as np
import torch

from repro_torch.core.records import (
    carry_frontier,
    cross_window_conflicts,
    wave_levels,
    window_conflicts,
)
from repro_torch.obs.profiler import annotate
from repro_torch.obs.stats import finalize_stats
from repro_torch.obs.trace import TID_COMM, current_tracer
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device
from repro_torch.utils.timing import block_all

ENGINES: dict[str, Type["Engine"]] = {}


def register_engine(cls: Type["Engine"]) -> Type["Engine"]:
    """Class decorator: add an Engine subclass to the registry."""
    if ENGINES.get(cls.name, cls) is not cls:
        raise ValueError(f"engine {cls.name!r} registered twice")
    ENGINES[cls.name] = cls
    return cls


def get_engine(name: str) -> Type["Engine"]:
    try:
        return ENGINES[name]
    except KeyError:
        raise ValueError(
            f"unknown engine {name!r}; registered: {sorted(ENGINES)}"
        ) from None


def make_engine(name: str, model, **kwargs) -> "Engine":
    """Build a registered engine; ``device`` defaults to the card."""
    return get_engine(name)(model, **kwargs)


class Engine(abc.ABC):
    """One way of executing a model's task chain on one device."""

    #: registry key
    name: str = "engine"

    #: default for the cross-window overlap knob (the ``*_overlap``
    #: registry entries flip it; ``overlap=None`` keeps the class default)
    default_overlap: bool = False

    def __init__(self, model, *, window: int = 256, strict: bool = True,
                 overlap: bool | None = None, device=None):
        self.model = model
        self.window = int(window)
        self.strict = strict
        self.overlap = (self.default_overlap if overlap is None
                        else bool(overlap))
        self.device = resolve_device(device)
        topo = getattr(model, "topology", None)
        if topo is not None and topo.device != self.device:
            raise ValueError(f"the model's topology is on {topo.device}, "
                             f"the engine runs on {self.device}")

    def _prepare_state(self, state):
        """The state the window executors take, from the caller's."""
        return state

    # ------------------------------------------------------ compiled costs
    def _cost_targets(self, base_key, state):
        """``(name, fn, example_args)`` triples for the engine's window
        executors (the functions ``run`` dispatches a window to), built
        on one window's schedule. ``state`` is already prepared
        (``_prepare_state`` has run). None = no such executor."""
        return None

    def compiled_costs(self, state, *, seed: int = 0):
        """Cost telemetry of this engine's window executors: ``{name:
        repro_torch.obs.costs.ExecutorCost}`` with the FLOPs and bytes
        accessed, the memory decomposition and the collectives by call
        site and loop depth (resolve them against executed iteration
        counts, e.g. the sharded engine's ``comm_iteration_counts``).
        Each executor runs once on clones, so ``state`` is not consumed.
        ``_prepare_state`` runs first, which resets a sharded engine's
        comm ledger: read ``comm_iteration_counts`` before. On a sharded
        engine every rank calls this together, as it calls ``run``.
        Returns None for overlapped runs (they dispatch the pair
        executors) and for engines without executors."""
        if self.overlap:
            return None
        from repro_torch.obs.costs import executor_cost

        self._check_state(state)
        state = self._prepare_state(state)
        targets = self._cost_targets(prng.key(seed, device=self.device),
                                     state)
        if not targets:
            return None
        return {name: executor_cost(fn, *args, name=name)
                for name, fn, args in targets}

    def _check_state(self, state) -> None:
        for k, x in state.items():
            if x.device != self.device:
                raise ValueError(f"state {k!r} is on {x.device}, the "
                                 f"engine runs on {self.device}")

    @abc.abstractmethod
    def run(self, state: Any, total_tasks: int, *, seed: int = 0
            ) -> tuple[Any, dict]:
        """Execute total_tasks tasks from the chain; returns (state, stats).

        stats always carries ``total_tasks``, ``n_windows``,
        ``total_waves`` and ``mean_parallelism``.
        """


class WindowedEngine(Engine):
    """Shared streaming loop: window t+1 is scheduled before window t
    executes. Subclasses provide ``_execute(state, sched)`` -> (state,
    n_waves) for one scheduled window, plus optional ``_prepare_state`` /
    ``_finalize_state`` / ``_extend_stats`` hooks (the sharded engines
    keep this rank's row block of the state between them and add their
    comm stats).

    **Cross-window overlap** (``overlap=True``, or the ``*_overlap``
    registry entries): when window k+1 is scheduled, the boundary step
    checks its tasks against window k's not-yet-drained tail
    (``cross_window_conflicts`` through the conflict kernel's block entry
    point), turns that block into a per-task level floor
    (``carry_frontier``) and re-levels window k+1 on it (the levels
    kernel with ``base``). Execution then runs *fused* waves: each wave
    of window k's drain also runs the window k+1 tasks of the same level,
    which never conflict with it by construction of the floor, so the
    result stays bit-exact. At most two windows are in flight. Overlapped
    subclasses provide
      * ``_schedule_ov(base_key, start, count)`` -> ``(recipes, valid,
        conf, extra)``, the conflict matrix kept for the re-leveling;
      * ``_execute_pair(state, cur, lv_cur, nxt, lv_nxt)`` -> ``(state,
        n_waves, lv_nxt_rebased)``, the fused drain of ``cur``;
      * ``_execute_drain(state, cur, lv)`` -> ``(state, n_waves)``, the
        last window's drain with no partner.
    """

    #: overlapped-mode hooks; None = barrier-only engine
    _schedule_ov = None
    _execute_pair = None
    _execute_drain = None

    def _finalize_state(self, state):
        """The caller's state back from the executors' (run's result)."""
        return state

    def _extend_stats(self, stats: dict) -> dict:
        """Engine-specific stats, added before ``finalize_stats``."""
        return stats

    def _schedule_window_ov(self, base_key, start: int, count: int):
        """Create one window of tasks and its conflict matrix (conflict
        kernel). Always W tasks: the last window is masked by ``valid``,
        as in the reference, so its schedule matches. Returns (recipes,
        valid, conf), all enqueued on the device, none waited for."""
        with annotate("protocol.create_tasks"):
            recipes = self.model.create_tasks(base_key, start, self.window)
        valid = torch.arange(self.window, device=self.device) < count
        conf = window_conflicts(self.model, recipes, valid,
                                strict=self.strict)
        return recipes, valid, conf

    def _schedule(self, base_key, start: int, count: int):
        """One window reduced to wave levels (conflict + levels kernels):
        (recipes, valid, levels)."""
        recipes, valid, conf = self._schedule_window_ov(base_key, start,
                                                        count)
        return recipes, valid, wave_levels(conf, valid)

    def _execute(self, state, sched):  # pragma: no cover - abstract
        raise NotImplementedError

    # ------------------------------------------------------------- tracing
    #
    # Every hook below is reached only when a tracer is installed; the run
    # loops check ``current_tracer() is None`` once per run. With tracing
    # on, span boundaries fence with ``block_all`` (a synchronize on the
    # card), which serializes the double-buffered pipeline on purpose to
    # attribute wall time to the schedule, boundary and execute steps.

    def _trace_parts(self, sched, levels=None):
        """(levels, write_agents, rows) of one window's schedule, for the
        per-wave trace attributes; ``levels`` overrides the schedule's own
        (the overlapped loop re-levels and rebases). None disables
        per-wave spans for this engine."""
        return None

    def _trace_wave_comm(self, np_parts, n_waves: int):
        """Per-wave comm attributes (list of dicts with ``rung``/``rows``
        /``bytes`` and optionally ``owned`` per-rank task counts), or
        None for engines that ship nothing."""
        return None

    def _trace_execute_args(self) -> dict:
        """Extra args for a just-closed execute span (e.g. the sharded
        engine's comm-ladder rung)."""
        return {}

    def _dispatch_schedule(self, tr, base_key, start: int, count: int, *,
                           index: int, ov: bool = False):
        """Enqueue one window's schedule in the range
        ``protocol.schedule``, inside a fenced ``schedule`` span (which
        opens that range) when tracing is on."""
        fn = self._schedule_ov if ov else self._schedule
        if tr is None:
            with annotate("protocol.schedule"):
                return fn(base_key, start, count)
        with tr.span("schedule", index=index, start=start, count=count):
            sched = fn(base_key, start, count)
            block_all(sched)
        return sched

    def _trace_window(self, tr, sp, parts, n_waves: int) -> None:
        """Emit one ``wave`` span per executed wave, width-attributed
        inside the closed execute span ``sp``, and per-wave
        ``halo_gather`` spans on the comm thread for engines that ship
        rows. ``parts`` holds one ``_trace_parts`` triple per live window
        (two for a fused pair drain); a wave's width counts the tasks of
        every part at its level."""
        parts = [p for p in parts if p is not None]
        if n_waves <= 0 or not parts:
            return
        widths = np.zeros(n_waves, np.int64)
        np_parts = []
        for lv, wa, rows in parts:
            lv = lv.cpu().numpy()
            np_parts.append((lv,
                             None if wa is None else wa.cpu().numpy(),
                             None if rows is None else rows.cpu().numpy()))
            sel = lv[(lv >= 0) & (lv < n_waves)]
            if sel.size:
                widths += np.bincount(sel, minlength=n_waves)[:n_waves]
        comm = self._trace_wave_comm(np_parts, n_waves)
        window = sp.args.get("index")
        args = [{"window": window, "level": w, "width": int(widths[w])}
                for w in range(n_waves)]
        if comm is not None:
            for a, c in zip(args, comm):
                owned = c.pop("owned", None)
                if owned is not None:
                    a["owned"] = owned
        slots = tr.subdivide(sp, "wave", widths.tolist(), args)
        if comm is not None:
            for w, ((ts, dur), c) in enumerate(zip(slots, comm)):
                if c.get("rows"):
                    tr.complete("halo_gather", ts, dur, tid=TID_COMM,
                                window=window, level=w, attributed=True,
                                **c)

    def _traced_execute(self, tr, args: dict, parts, fn):
        """``fn()`` -> (state, n_waves, ...) inside an ``execute`` span with
        ``args``, fenced on the new state, then the window's wave spans
        over the level vectors ``parts``."""
        with tr.span("execute", **args) as sp:
            out = fn()
            block_all(out[0])
        sp.args["n_waves"] = out[1]
        sp.args.update(self._trace_execute_args())
        self._trace_window(tr, sp, parts, out[1])
        return out

    def run(self, state: Any, total_tasks: int, *, seed: int = 0):
        self._check_state(state)
        if self.overlap:
            if self._schedule_ov is None:
                raise ValueError(
                    f"engine {self.name!r} does not implement cross-window "
                    "overlap; use overlap=False (the barrier fallback)")
            return self._run_overlapped(state, total_tasks, seed=seed)
        tr = current_tracer()
        base_key = prng.key(seed, device=self.device)
        state = self._prepare_state(state)
        t = 0
        n_windows = 0
        total_waves = 0
        run_cm = (tr.span("run", engine=self.name, window=self.window,
                          total_tasks=total_tasks, overlap=False)
                  if tr is not None else nullcontext())
        with run_cm:
            nxt = self._dispatch_schedule(
                tr, base_key, 0, min(self.window, total_tasks), index=0)
            while t < total_tasks:
                k = min(self.window, total_tasks - t)
                cur = nxt
                if t + k < total_tasks:
                    # double buffering: enqueue window t+1's schedule
                    # (conflict matrix + levels) before window t's waves
                    nxt = self._dispatch_schedule(
                        tr, base_key, t + k,
                        min(self.window, total_tasks - t - k),
                        index=n_windows + 1)
                if tr is None:
                    state, n_waves = self._execute(state, cur)
                else:
                    state, n_waves = self._traced_execute(
                        tr, {"index": n_windows, "start": t, "count": k},
                        [self._trace_parts(cur)],
                        lambda: self._execute(state, cur))
                total_waves += n_waves
                n_windows += 1
                t += k
        stats = {
            "total_tasks": total_tasks,
            "n_windows": n_windows,
            "total_waves": total_waves,
            "mean_parallelism": total_tasks / max(total_waves, 1),
            "overlap": False,
        }
        state = self._finalize_state(state)
        return state, finalize_stats(self._extend_stats(stats))

    # ------------------------------------------------- cross-window overlap
    def _boundary(self, rec_a, lv_a, rec_b, valid_b, conf_b):
        """The boundary step k -> k+1: cross-window record check, carry
        frontier, floored re-leveling, and the per-boundary stats — all
        enqueued on the device, none read here. Returns (lv_b, (depth,
        early, carry_mean, carry_max)), each stat a 0-d tensor: depth,
        early and carry_max int64, carry_mean float32 (the reference's
        int32 sum over an int32 count is a float32 division)."""
        w = self.window
        alive_a = lv_a >= 0          # window k's not-yet-drained tail
        cross = cross_window_conflicts(self.model, rec_a, alive_a, rec_b,
                                       valid_b, strict=self.strict)
        carry = carry_frontier(cross, lv_a)
        lv_b = wave_levels(conf_b, valid_b, base=carry)
        n_waves_a = lv_a.max() + 1
        # overlap depth: tail waves of k during which k+1 tasks run; the
        # levels of early tasks are < n_waves_a <= w, the rest go to the
        # scratch slot w (a scatter of a scalar: assigning a host-side
        # True would be a blocking copy, a host sync per boundary)
        early = valid_b & (lv_b < n_waves_a)
        occ = torch.zeros(w + 1, dtype=torch.int32,
                          device=lv_b.device).scatter_(
                              0, torch.where(early, lv_b.long(), w), 1)
        carry_v = torch.where(valid_b, carry, 0)
        n_valid = valid_b.sum().clamp(min=1)
        bstats = (occ[:w].sum(), early.sum(),
                  carry_v.sum().to(torch.float32) / n_valid.to(torch.float32),
                  carry_v.max().to(torch.int64))
        return lv_b, bstats

    def _run_overlapped(self, state: Any, total_tasks: int, *,
                        seed: int = 0):
        """The overlapped loop. One host sync per window: the fused
        drain reads its wave count; the boundary stats stay on the device
        and are read once after the loop."""
        tr = current_tracer()
        base_key = prng.key(seed, device=self.device)
        state = self._prepare_state(state)
        t = 0
        n_windows = 0
        total_waves = 0
        bstats = []
        run_cm = (tr.span("run", engine=self.name, window=self.window,
                          total_tasks=total_tasks, overlap=True)
                  if tr is not None else nullcontext())
        with run_cm:
            cur = self._dispatch_schedule(
                tr, base_key, 0, min(self.window, total_tasks), index=0,
                ov=True)
            lv = wave_levels(cur[2], cur[1])  # first window: no carry floor
            while t < total_tasks:
                k = min(self.window, total_tasks - t)
                if t + k < total_tasks:
                    # enqueue window k+1's schedule and boundary (cross
                    # block, carry frontier, floored levels) before the
                    # fused drain of window k, on the one stream
                    nxt = self._dispatch_schedule(
                        tr, base_key, t + k,
                        min(self.window, total_tasks - t - k),
                        index=n_windows + 1, ov=True)
                    if tr is None:
                        with annotate("protocol.boundary"):
                            lv_nxt, b = self._boundary(cur[0], lv, nxt[0],
                                                       nxt[1], nxt[2])
                    else:
                        with tr.span("boundary", index=n_windows) as bsp:
                            lv_nxt, b = self._boundary(cur[0], lv, nxt[0],
                                                       nxt[1], nxt[2])
                            block_all((lv_nxt, b))
                        bsp.args.update(
                            overlap_depth=int(b[0]), early_tasks=int(b[1]),
                            carry_mean=float(b[2]), carry_max=int(b[3]))
                    bstats.append(b)
                    if tr is None:
                        state, n_waves, lv_nxt = self._execute_pair(
                            state, cur, lv, nxt, lv_nxt)
                    else:
                        # wave widths from the pre-rebase levels of k+1
                        state, n_waves, lv_nxt = self._traced_execute(
                            tr, {"index": n_windows, "start": t,
                                 "count": k, "fused": True},
                            [self._trace_parts(cur, lv),
                             self._trace_parts(nxt, lv_nxt)],
                            lambda: self._execute_pair(state, cur, lv, nxt,
                                                       lv_nxt))
                    cur, lv = nxt, lv_nxt
                else:
                    # last window: no partner — drain through the barrier
                    # executor
                    if tr is None:
                        state, n_waves = self._execute_drain(state, cur, lv)
                    else:
                        state, n_waves = self._traced_execute(
                            tr, {"index": n_windows, "start": t,
                                 "count": k, "drain": True},
                            [self._trace_parts(cur, lv)],
                            lambda: self._execute_drain(state, cur, lv))
                total_waves += n_waves
                n_windows += 1
                t += k
        if bstats:  # read the per-boundary stats once
            ints = torch.stack([torch.stack([b[0], b[1], b[3]])
                                for b in bstats]).cpu().tolist()
            cmeans = torch.stack([b[2] for b in bstats]).cpu().tolist()
        else:
            ints, cmeans = [], []
        depths = [r[0] for r in ints]
        earlies = [r[1] for r in ints]
        cmaxs = [r[2] for r in ints]
        stats = {
            "total_tasks": total_tasks,
            "n_windows": n_windows,
            "total_waves": total_waves,
            "mean_parallelism": total_tasks / max(total_waves, 1),
            "overlap": True,
            "n_boundaries": len(bstats),
            "mean_overlap_depth": (sum(depths) / len(depths)
                                   if depths else 0.0),
            "max_overlap_depth": max(depths, default=0),
            "overlap_tasks_early": sum(earlies),
            "carry_frontier_mean": (sum(cmeans) / len(cmeans)
                                    if cmeans else 0.0),
            "carry_frontier_max": max(cmaxs, default=0),
        }
        state = self._finalize_state(state)
        return state, finalize_stats(self._extend_stats(stats))

"""Discrete-event simulator of the paper's worker–chain protocol (§3.3).

Port of ``repro/core/workersim.py`` (pure Python, ``heapq``): the same
events in the same order, the same tie-breaks and the same float
arithmetic, so a run equals the reference's ``DESResult`` field for field.

This is the *protocol-faithful* reproduction path: n workers, per-task locks
(a worker cannot move onto a stationed, non-executing worker — hand-over-hand
locking), the enter-lock (serialized creation, incl. the empty-chain case),
the erase-lock (serialized erasure), cycles, and the C tasks-created-per-cycle
limit. Costs are supplied by a model adapter (``des_model``); they are to be
calibrated against per-task execution times measured on the card.

Event granularity: one event per worker move/decision plus one completion
event per execution — the honest level at which occupancy ("is some worker
stationed there *now*?") and execution state must be evaluated. Executing
tasks remain on the chain until their completion event, so later workers
correctly integrate their recipes (precedence is never violated).

The simulator never executes model math; it replays the schedule the
protocol would produce and integrates its makespan. Model semantics are
held by the engines' equality with the sequential oracle.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import Any, Callable, Optional

from repro_torch.core.chain import TaskChain, TaskNode


@dataclass
class DESCosts:
    """Protocol overhead constants (seconds)."""

    visit: float = 2e-7     # record integration + pointer move (one list hop)
    create: float = 5e-7    # creation bookkeeping (excl. model creation work)
    erase: float = 2e-7     # erase under erase-lock
    enter: float = 2e-7     # return to chain start / enter chain


@dataclass
class DESModel:
    """Host-side adapter for a MABS model.

    recipes_fn(i)        -> recipe payload for global task index i
    exec_cost_fn(recipe) -> execution-part cost in seconds
    create_cost_fn()     -> model-side creation cost in seconds
    record_new()         -> empty record
    record_add(rec, recipe) -> record with recipe folded in (may mutate)
    depends(rec, recipe) -> True if task-at-hand depends on the record
    """

    recipes_fn: Callable[[int], Any]
    exec_cost_fn: Callable[[Any], float]
    create_cost_fn: Callable[[], float]
    record_new: Callable[[], Any]
    record_add: Callable[[Any, Any], Any]
    depends: Callable[[Any, Any], bool]


@dataclass
class _Worker:
    wid: int
    node: Optional[TaskNode] = None      # current station (None = outside chain)
    record: Any = None
    created_this_cycle: int = 0
    executed: int = 0
    visited: int = 0
    blocked_on: Optional[TaskNode] = None


@dataclass
class DESResult:
    makespan: float
    executed_per_worker: list[int]
    visits_per_worker: list[int]
    n_tasks: int
    events: int
    max_chain_len: int


class ProtocolSimulator:
    """Event-driven simulation of the worker–chain workflow."""

    def __init__(self, model: DESModel, *, n_workers: int, total_tasks: int,
                 tasks_per_cycle: int = 6, costs: DESCosts | None = None):
        self.model = model
        self.n = n_workers
        self.total = total_tasks
        self.C = tasks_per_cycle
        self.costs = costs or DESCosts()

    # ------------------------------------------------------------------
    def run(self) -> DESResult:
        model, costs = self.model, self.costs
        chain = TaskChain()
        workers = [_Worker(wid=i) for i in range(self.n)]
        seq = itertools.count()           # FIFO tie-break
        q: list[tuple[float, int, int, str]] = []
        creation_busy_until = 0.0         # enter-lock: one creation at a time
        erase_busy_until = 0.0            # erase-lock: one erase at a time
        executed = 0
        events = 0
        max_chain = 0
        waiters: dict[int, list[int]] = {}  # task index -> blocked worker ids
        done_time = 0.0

        def push(t: float, wid: int, kind: str = "decide") -> None:
            heapq.heappush(q, (t, next(seq), wid, kind))

        def wake_waiters(node: TaskNode, t: float) -> None:
            for wid in waiters.pop(node.index, []):
                workers[wid].blocked_on = None
                push(t, wid)

        for w in workers:
            push(0.0, w.wid)

        while q:
            t, _, wid, kind = heapq.heappop(q)
            events += 1
            w = workers[wid]
            max_chain = max(max_chain, len(chain))

            # ---------------- completion of an execution ----------------
            if kind == "finish":
                node = w.node
                assert node is not None and node.executing_by == wid
                t_erase_done = max(t, erase_busy_until) + costs.erase
                erase_busy_until = t_erase_done
                chain.erase(node)
                node.executing_by = None
                node.occupant = None
                executed += 1
                w.executed += 1
                w.node = None
                wake_waiters(node, t_erase_done)
                done_time = max(done_time, t_erase_done)
                push(t_erase_done + costs.enter, wid)
                continue

            if w.blocked_on is not None:
                continue  # stale event; this worker is parked until woken

            # ---------------- (re-)entering the chain -------------------
            if w.node is None:
                w.record = model.record_new()
                w.created_this_cycle = 0
                target = chain.head
                if target is None:
                    if chain.n_created < self.total:
                        # create under the enter-lock
                        t_start = max(t, creation_busy_until)
                        dt = costs.create + model.create_cost_fn()
                        creation_busy_until = t_start + dt
                        node = chain.append(model.recipes_fn(chain.n_created))
                        node.occupant = wid
                        w.node = node
                        push(t_start + dt, wid)
                    elif executed >= self.total:
                        done_time = max(done_time, t)  # retire
                    else:
                        # everything created; stragglers still executing.
                        # Wait for the next completion instead of spinning.
                        push(t + 50 * costs.enter, wid)
                    continue
                node = target
            else:
                node = w.node

            # a worker "in transit" may arrive at a task that was executed
            # and erased meanwhile — follow next pointers to the first
            # live task (erased nodes keep their next pointer)
            while node is not None and node.erased:
                node = node.next
            if node is None:
                # overshot the tail: create or end the cycle
                w.node = None
                if chain.n_created < self.total \
                        and w.created_this_cycle < self.C:
                    t_start = max(t, creation_busy_until)
                    dt = costs.create + model.create_cost_fn()
                    creation_busy_until = t_start + dt
                    new_node = chain.append(model.recipes_fn(chain.n_created))
                    new_node.occupant = wid
                    w.node = new_node
                    w.created_this_cycle += 1
                    push(t_start + dt, wid)
                else:
                    push(t + costs.enter, wid)
                continue
            w.node = node

            # ------------- per-task lock: can we stand here? -------------
            if (node.occupant is not None and node.occupant != wid
                    and node.executing_by is None):
                w.blocked_on = node
                waiters.setdefault(node.index, []).append(wid)
                continue
            if node.occupant is None:
                node.occupant = wid
            w.node = node

            # --------------------- decision ------------------------------
            busy = node.executing_by is not None and node.executing_by != wid
            dependent = busy or model.depends(w.record, node.recipe)

            if not dependent:
                # EXECUTE (task stays on chain until "finish"). Workers
                # blocked behind this station may now pass (paper: a located
                # worker may be passed once it is executing).
                node.executing_by = wid
                wake_waiters(node, t)
                push(t + model.exec_cost_fn(node.recipe), wid, "finish")
                continue

            # SKIP: integrate recipe, hand-over-hand move to next
            w.record = model.record_add(w.record, node.recipe)
            w.visited += 1
            if node.occupant == wid:
                node.occupant = None
                wake_waiters(node, t + costs.visit)
            nxt = node.next
            if nxt is not None:
                w.node = nxt
                push(t + costs.visit, wid)
                continue

            # ----------------- at the chain tail: create -----------------
            if chain.n_created < self.total and w.created_this_cycle < self.C:
                t_start = max(t + costs.visit, creation_busy_until)
                dt = costs.create + model.create_cost_fn()
                creation_busy_until = t_start + dt
                new_node = chain.append(model.recipes_fn(chain.n_created))
                new_node.occupant = wid
                w.node = new_node
                w.created_this_cycle += 1
                push(t_start + dt, wid)
            else:
                # cycle ends: leave the chain, return to start
                w.node = None
                push(t + costs.visit + costs.enter, wid)

        if executed < self.total:
            raise RuntimeError(
                f"protocol deadlock: executed {executed}/{self.total}")

        return DESResult(
            makespan=done_time,
            executed_per_worker=[w.executed for w in workers],
            visits_per_worker=[w.visited for w in workers],
            n_tasks=executed,
            events=events,
            max_chain_len=max_chain,
        )

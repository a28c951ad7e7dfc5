"""Continuous-batching serving engine — the paper's protocol applied to LLM
inference.

Port of ``repro/serving/engine.py``. The mapping onto the paper's
constructs is the reference's:

  task      — one unit of request work: a prefill chunk or one decode step
  recipe    — (request id, kind, slot); created when the request's previous
              task completes
  record    — "which requests already have a task ahead of me in this
              window": the conflict rule is *same request id* (each
              request's tasks touch only its own slot state, so different
              requests commute)
  chain     — the pending-task window, rebuilt every iteration from
              per-request progress and the arrival queue
  wave      — the commuting front tasks, run as prefill chunks plus ONE
              batched decode step

The window goes through the port's records (``prefix_conflicts``,
``wave_levels``): on the card the level recurrence is the hand-written
levels kernel, once per iteration. Long prompts are split into
``prefill_chunk`` tasks so that a long prompt never blocks the decode
wave of the other requests.

Past a sliding window the engine's tokens differ from the reference
engine's: a prefill chunk attends over its ring and its own fresh keys
before it writes the ring (``models/attention.py``), so it keeps the
keys its first queries still see, which the reference's ring has already
overwritten. The engine then equals one-shot prefill and decoding, and
the reference's engine does not. Below the window the two agree.

State handling differs from the reference's copies, not in result: the
model writes its states in place. A slot's state is read as views of the
stacked states (``_gather_state``), so a prefill chunk writes straight
into its slot; a new request's slot is reset with one copy per leaf
(``_scatter_state``); both walk the state tree leaf by leaf, as the
reference's do, so a KV ring and an RWKV state alike. The decode wave
computes every slot but commits only the wave's
(``decode_step(commit=...)``), so a slot that is mid-prefill or idle
keeps its ``length``, ``kpos``, ``k`` and ``v`` (and hymba's SSM state,
or its RWKV ``s`` and token-shift ``last``s) and ``pos``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core.records import prefix_conflicts, wave_levels
from repro_torch.models.attention import map_state, state_leaves
from repro_torch.obs.profiler import annotate
from repro_torch.obs.stats import finalize_stats
from repro_torch.obs.trace import current_tracer
from repro_torch.utils.device import resolve_device
from repro_torch.utils.timing import block_all


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # [T] int32
    max_new_tokens: int
    eos_token: Optional[int] = None
    out_tokens: list = field(default_factory=list)
    slot: Optional[int] = None
    prefill_done: int = 0               # prompt tokens already prefilled
    done: bool = False


class _SlotConflicts:
    """Recipe/record adapter for the scheduler: same-request tasks conflict
    (serial chain per request); distinct requests commute."""

    @staticmethod
    def conflicts(a, b, *, strict: bool = True):
        return a["rid"] == b["rid"]


class ServingEngine:
    def __init__(self, model, params, *, n_slots: int, max_len: int,
                 prefill_chunk: int = 64, greedy: bool = True,
                 device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model is on {model.device}, the engine "
                             f"on {self.device}")
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.greedy = greedy

        self.states = model.init_states(n_slots, max_len)
        self.queue: list[Request] = []
        self.active: dict[int, Request] = {}      # slot -> request
        self.free_slots = list(range(n_slots))
        self.finished: list[Request] = []
        self.iterations = 0
        self.wave_sizes: list[int] = []
        self.prefill_tasks = 0
        self.decode_tasks = 0

    # ------------------------------------------------------------ admit
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        while self.queue and self.free_slots:
            req = self.queue.pop(0)
            req.slot = self.free_slots.pop(0)
            # reset the slot's streaming state (the previous occupant's KV
            # ring and position counter must not leak)
            self._scatter_state(
                self.model.init_states(1, self.max_len), req.slot)
            self.active[req.slot] = req

    # -------------------------------------------------------- scheduling
    def _build_window(self):
        """One pending task per active request (its chain head), in request
        arrival order — the engine's view of the paper's chain."""
        recipes = []
        for slot, req in sorted(self.active.items(), key=lambda kv: kv[1].rid):
            if req.done:
                continue
            if req.prefill_done < len(req.prompt):
                recipes.append({"rid": req.rid, "kind": 0, "slot": slot})
            elif len(req.out_tokens) < req.max_new_tokens:
                recipes.append({"rid": req.rid, "kind": 1, "slot": slot})
        return recipes

    def _schedule_wave(self, recipes):
        """Run the paper's scheduler over the window; return wave-0 tasks.
        With one task per request the wave is the whole window — the
        machinery matters when chains interleave."""
        if not recipes:
            return []
        w = len(recipes)
        arr = {"rid": torch.tensor([r["rid"] for r in recipes],
                                   dtype=torch.int32, device=self.device)}
        valid = torch.ones((w,), dtype=torch.bool, device=self.device)
        conf = prefix_conflicts(_SlotConflicts.conflicts, arr, valid)
        levels = wave_levels(conf, valid).cpu().numpy()
        return [r for r, lv in zip(recipes, levels) if lv == 0]

    # -------------------------------------------------------- execution
    @torch.inference_mode()
    def _scatter_state(self, slot_states: dict, slot: int):
        """Copy a single-slot state into the batched states, leaf by leaf
        (``pos`` on axis 0, the stacked segment leaves on axis 1)."""
        big = self.states

        def put(dst, axis, src):
            dst.select(axis, slot).copy_(src.select(axis, 0))

        put(big["pos"], 0, slot_states["pos"])
        for dst, src in zip(state_leaves(big["segs"]),
                            state_leaves(slot_states["segs"])):
            put(dst, 1, src)

    def _gather_state(self, slot: int) -> dict:
        """Views of one slot's state: writes through them land in the
        batched states."""
        return {"segs": map_state(lambda x: x.narrow(1, slot, 1),
                                  self.states["segs"]),
                "pos": self.states["pos"].narrow(0, slot, 1)}

    def _exec_prefill(self, task):
        req = self.active[task["slot"]]
        first = req.prefill_done == 0
        chunk = req.prompt[req.prefill_done:
                           req.prefill_done + self.prefill_chunk]
        t = len(chunk)
        batch = {"tokens": torch.as_tensor(
            np.asarray(chunk, np.int32), device=self.device)[None]}
        with annotate("protocol.prefill_chunk"):
            logits, _ = self.model.prefill(
                self.params, batch, self._gather_state(task["slot"]),
                chunked=True, include_prefix=first)
        req.prefill_done += t
        if req.prefill_done >= len(req.prompt):
            # prompt complete: the prefill's last logits seed decoding
            self._append_token(req, int(torch.argmax(logits[0])))

    def _exec_decode_wave(self, tasks):
        slots = [t["slot"] for t in tasks]
        last = np.zeros((self.n_slots, 1), np.int32)
        mask = np.zeros((self.n_slots,), bool)
        for s in slots:
            last[s, 0] = self.active[s].out_tokens[-1]
            mask[s] = True
        with annotate("protocol.decode_wave"):
            # every slot is computed, only the wave's are committed (the
            # conflict-free wave write)
            logits, _ = self.model.decode_step(
                self.params, torch.as_tensor(last, device=self.device),
                self.states, commit=torch.as_tensor(mask,
                                                    device=self.device))
        toks = torch.argmax(logits, dim=-1).cpu().numpy()
        for s in slots:
            self._append_token(self.active[s], int(toks[s]))

    def _append_token(self, req: Request, tok: int):
        req.out_tokens.append(tok)
        if ((req.eos_token is not None and tok == req.eos_token)
                or len(req.out_tokens) >= req.max_new_tokens):
            req.done = True
            self.finished.append(req)
            self.free_slots.append(req.slot)
            del self.active[req.slot]

    # ------------------------------------------------------------- run
    def step(self) -> bool:
        """One protocol iteration. Returns False when fully idle.

        With a span tracer installed (``repro_torch.obs.tracing()``) each
        iteration emits a fenced ``schedule`` span (admit + window build
        + wave-0 selection) and an ``execute`` span (prefill chunks + the
        batched decode wave), as the reference does. The untraced path is
        guarded by one ``current_tracer()`` check."""
        tr = current_tracer()
        if tr is None:
            self._admit()
            wave = self._schedule_wave(self._build_window())
        else:
            with tr.span("schedule", index=self.iterations):
                self._admit()
                wave = self._schedule_wave(self._build_window())
        if not wave:
            return bool(self.queue or self.active)
        self.wave_sizes.append(len(wave))
        prefills = [t for t in wave if t["kind"] == 0]
        decodes = [t for t in wave if t["kind"] == 1]
        if tr is None:
            self._exec_wave(prefills, decodes)
        else:
            with tr.span("execute", index=self.iterations,
                         prefills=len(prefills), decodes=len(decodes)) as sp:
                self._exec_wave(prefills, decodes)
                block_all(self.states)
                sp.args["wave"] = len(prefills) + len(decodes)
        self.prefill_tasks += len(prefills)
        self.decode_tasks += len(decodes)
        self.iterations += 1
        return True

    def _exec_wave(self, prefills, decodes):
        for t in prefills:
            self._exec_prefill(t)
        if decodes:
            self._exec_decode_wave(decodes)

    def run(self, max_iterations: int = 100_000):
        tr = current_tracer()
        if tr is None:
            it = 0
            while self.step():
                it += 1
                if it > max_iterations:
                    raise RuntimeError("engine did not converge")
            return self.finished
        with tr.span("run", engine="serving", window=self.n_slots,
                     total_tasks=0) as sp:
            it = 0
            while self.step():
                it += 1
                if it > max_iterations:
                    raise RuntimeError("engine did not converge")
            block_all(self.states)
            sp.args["total_tasks"] = self.prefill_tasks + self.decode_tasks
        return self.finished

    def run_stats(self) -> dict:
        """Engine-run statistics through the stats registry
        (``finalize_stats``): one iteration = one window with one executed
        wave, plus the serving-group task and request counters."""
        waves = self.wave_sizes
        total = self.prefill_tasks + self.decode_tasks
        return finalize_stats({
            "total_tasks": total,
            "n_windows": self.iterations,
            "total_waves": len(waves),
            "mean_parallelism": total / max(len(waves), 1),
            "serving_prefill_tasks": self.prefill_tasks,
            "serving_decode_tasks": self.decode_tasks,
            "serving_requests_finished": len(self.finished),
        })

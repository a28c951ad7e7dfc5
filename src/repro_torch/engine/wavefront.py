"""Single-device wavefront engine.

Port of ``repro/engine/wavefront.py``. Streams the chain through windows
of W tasks: each window is scheduled (prefix-conflict matrix through the
conflict kernel, wave levels through the levels kernel) and executed one
vectorized wave at a time. By default the window boundary is a
conservative barrier; the shared ``WindowedEngine`` loop enqueues window
t+1's schedule before window t's waves.

With ``overlap=True`` (or the ``wavefront_overlap`` registry entry) the
barrier falls: window k+1 is re-leveled against the carry-over conflict
frontier of window k's tail (``WindowedEngine`` docstring) and the two
windows drain in *fused* waves — each wave executes window k's tasks at
that level and then window k+1's, which never conflict with them by
construction of the frontier. The result stays bit-exact against the
sequential oracle; what changes is the wave count: independent head
waves of k+1 ride along with k's tail instead of waiting behind it.
"""
from __future__ import annotations

import torch

from repro_torch.core.wavefront import execute_window
from repro_torch.engine.base import WindowedEngine, register_engine
from repro_torch.obs.costs import current_recorder, loop as cost_loop
from repro_torch.obs.profiler import annotate


@register_engine
class WavefrontEngine(WindowedEngine):
    name = "wavefront"

    def _execute(self, state, sched):
        recipes, valid, levels = sched
        return execute_window(self.model, state, recipes, valid,
                              strict=self.strict, levels=levels)

    def _schedule_ov(self, base_key, start: int, count: int):
        recipes, valid, conf = self._schedule_window_ov(base_key, start,
                                                        count)
        return recipes, valid, conf, None

    def _execute_pair(self, state, cur, lv_a, nxt, lv_b):
        """Fused drain of window k (``cur``, levels ``lv_a``) with window
        k+1 (``nxt``, floored levels ``lv_b``) riding along. Reads the
        wave count — the window's one host sync; a window whose tasks all
        ran early has none left and runs zero waves."""
        rec_a, rec_b = cur[0], nxt[0]
        with annotate("protocol.execute_pair"):
            n_waves = int(lv_a.max()) + 1
            with cost_loop(current_recorder()):
                for w in range(n_waves):
                    # fused wave: window k's tasks at level w, then window
                    # k+1's — the carry frontier keeps the two masks
                    # conflict-free
                    with annotate("protocol.wave", wave=w):
                        state = self.model.execute_wave(state, rec_a,
                                                        lv_a == w)
                        state = self.model.execute_wave(state, rec_b,
                                                        lv_b == w)
            # rebase the next window onto the new level clock; executed
            # (and invalid) tasks drop to -1
            lv_b = torch.where(lv_b >= n_waves, lv_b - n_waves, -1)
        return state, n_waves, lv_b

    def _trace_parts(self, sched, levels=None):
        # the barrier schedule carries its levels in slot 2; the
        # overlapped loop re-levels and passes them explicitly. One
        # device ships no rows: no write targets or halo rows to trace
        return (sched[2] if levels is None else levels), None, None

    def _execute_drain(self, state, cur, lv):
        """Partnerless drain (the last or only window) through the
        barrier executor: no empty partner waves."""
        return self._execute(state, (cur[0], cur[1], lv))

    def _cost_targets(self, base_key, state):
        sched = self._schedule(base_key, 0, self.window)
        return [("execute_window", self._execute, (state, sched))]


@register_engine
class WavefrontOverlapEngine(WavefrontEngine):
    """``wavefront`` with cross-window overlap on by default; the plain
    ``wavefront`` engine stays the registered barrier fallback."""

    name = "wavefront_overlap"
    default_overlap = True


#: The reference's name for the pre-registry runner class.
WavefrontRunner = WavefrontEngine

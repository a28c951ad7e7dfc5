"""Single-device wavefront engine.

Port of ``repro/engine/wavefront.py`` (the barrier loop only). Streams the
chain through windows of W tasks: each window is scheduled (prefix-
conflict matrix through the conflict kernel, wave levels through the
levels kernel) and executed one vectorized wave at a time. The window
boundary is a conservative barrier; the shared ``WindowedEngine`` loop
enqueues window t+1's schedule before window t's waves.

``wavefront_overlap`` (cross-window record carry-over) is not ported yet.
"""
from __future__ import annotations

from repro_torch.core.wavefront import execute_window
from repro_torch.engine.base import WindowedEngine, register_engine


@register_engine
class WavefrontEngine(WindowedEngine):
    name = "wavefront"

    def _execute(self, state, sched):
        recipes, valid, levels = sched
        return execute_window(self.model, state, recipes, valid,
                              strict=self.strict, levels=levels)

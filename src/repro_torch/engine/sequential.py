"""Sequential oracle engine: the chain order, one task at a time.

Port of ``repro/engine/sequential.py`` — the correctness reference every
other engine is held against (bit-exact under the strict hazard rule).
With a tracer installed (``repro_torch.obs.tracing``) each window of the
chain is one fenced ``execute`` span, inside a ``run`` span.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Any

from repro_torch.engine.base import Engine, register_engine
from repro_torch.obs.stats import finalize_stats
from repro_torch.obs.trace import current_tracer
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device
from repro_torch.utils.timing import block_all


def run_sequential(model, state, total_tasks: int, *, seed: int = 0,
                   window: int = 256, device=None):
    """Oracle runner: same task stream, strictly sequential execution."""
    tr = current_tracer()
    base_key = prng.key(seed, device=resolve_device(device))
    t = 0
    index = 0
    while t < total_tasks:
        k = min(window, total_tasks - t)
        if tr is None:
            recipes = model.create_tasks(base_key, t, window)
            state = model.execute_sequential(state, recipes, k)
        else:
            with tr.span("execute", index=index, start=t, count=k,
                         sequential=True):
                recipes = model.create_tasks(base_key, t, window)
                state = model.execute_sequential(state, recipes, k)
                block_all(state)
        t += k
        index += 1
    return state


@register_engine
class SequentialEngine(Engine):
    """Registry wrapper around ``run_sequential`` (stats are trivial:
    every task is its own wave)."""

    name = "sequential"

    def run(self, state: Any, total_tasks: int, *, seed: int = 0):
        self._check_state(state)
        tr = current_tracer()
        run_cm = (tr.span("run", engine=self.name, window=self.window,
                          total_tasks=total_tasks, overlap=False)
                  if tr is not None else nullcontext())
        with run_cm:
            state = run_sequential(self.model, state, total_tasks,
                                   seed=seed, window=self.window,
                                   device=self.device)
        stats = {
            "total_tasks": total_tasks,
            "n_windows": -(-total_tasks // self.window) if total_tasks else 0,
            "total_waves": total_tasks,
            "mean_parallelism": 1.0,
        }
        return state, finalize_stats(stats)

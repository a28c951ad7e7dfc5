"""Wave-at-a-time window execution — the vector core of the protocol.

Port of ``repro/core/wavefront.py``. Given a window of recipes and their
wave levels, executes the window one wave at a time; each wave is one
masked batch through ``model.execute_wave``. Identical to sequential
chain execution, because waves run in topological order and the tasks of
a wave commute.

The reference loops over waves on the device (a ``lax.while_loop`` on the
dynamic ``n_waves``). PyTorch has no device-side loop, so here the loop
runs on the host and needs the wave count first: ``int(levels.max())`` —
**one host sync per window**, and none per wave. The window and each wave
open the reference's ``protocol.execute_window`` and ``protocol.wave``
profiler ranges (``obs/profiler.py``); to an installed cost recorder
(``obs/costs.py``) the wave loop is a data-dependent loop, depth 1.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.records import wave_levels, window_conflicts
from repro_torch.obs.costs import current_recorder, loop as cost_loop
from repro_torch.obs.profiler import annotate


def execute_window(model, state, recipes, valid: torch.Tensor, *,
                   strict: bool = True,
                   levels: torch.Tensor | None = None):
    """Execute one window of tasks by waves. Returns (state, n_waves).

    Scheduling (the conflict matrix and the wave levels) goes through the
    model's footprint protocol when it has one. Pass precomputed
    ``levels`` to split scheduling from execution (the engines do).
    """
    if levels is None:
        conf = window_conflicts(model, recipes, valid, strict=strict)
        levels = wave_levels(conf, valid)
    n_waves = int(levels.max()) + 1  # the window's one host sync
    dev = levels.device
    with annotate("protocol.execute_window", dev), \
            cost_loop(current_recorder()):
        for w in range(n_waves):
            with annotate("protocol.wave", dev):
                state = model.execute_wave(state, recipes, levels == w)
    return state, n_waves


def window_schedule_stats(model, recipes, valid: torch.Tensor, *,
                          strict: bool = True) -> dict:
    """Host-side scheduling statistics for a window: wave count, wave
    sizes, parallelism profile."""
    conf = window_conflicts(model, recipes, valid, strict=strict)
    lv = wave_levels(conf, valid).cpu().numpy()
    lv = lv[lv >= 0]
    n_waves = int(lv.max()) + 1 if lv.size else 0
    sizes = np.bincount(lv, minlength=n_waves) if n_waves else np.array([])
    return {
        "n_tasks": int(lv.size),
        "n_waves": n_waves,
        "wave_sizes": sizes,
        "mean_parallelism": float(lv.size / max(n_waves, 1)),
        "conflict_density": float(conf.sum())
        / max(1, lv.size * (lv.size - 1) / 2),
    }


def __getattr__(name):  # PEP 562: lazy, so core and engine import no cycle
    if name == "WavefrontRunner":
        from repro_torch.engine.wavefront import WavefrontRunner

        return WavefrontRunner
    if name == "run_sequential":
        from repro_torch.engine.sequential import run_sequential

        return run_sequential
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

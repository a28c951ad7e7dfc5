"""Execution-engine interface and registry.

Port of ``repro/engine/base.py``. An *engine* binds a ``MABSModel`` to a
way of running its task chain: strictly sequentially (the oracle) or by
vectorized waves on one device. All engines consume the identical task
stream (``create_tasks`` keyed by the global chain index) and produce
bit-identical state under the strict hazard rule.

    from repro_torch.engine import make_engine
    eng = make_engine("wavefront", model, window=4096)   # on the card
    state, stats = eng.run(state, total_tasks, seed=0)

``WindowedEngine`` fixes the streaming structure: windows of W tasks, each
scheduled (conflict matrix + wave levels) and then executed wave by wave,
with a double-buffered window pipeline — window t+1's schedule is
enqueued before window t's waves, on the one stream that keeps the order.

Not ported yet: cross-window overlap (``overlap=True`` raises), the
tracing hooks and the compiled-cost hooks.
"""
from __future__ import annotations

import abc
from typing import Any, Type

import torch

from repro_torch.core.records import wave_levels, window_conflicts
from repro_torch.obs.stats import finalize_stats
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device

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

    def __init__(self, model, *, window: int = 256, strict: bool = True,
                 overlap: bool | None = None, device=None):
        self.model = model
        self.window = int(window)
        self.strict = strict
        self.overlap = bool(overlap)
        self.device = resolve_device(device)
        topo = getattr(model, "topology", None)
        if topo is not None and topo.device != self.device:
            raise ValueError(f"the model's topology is on {topo.device}, "
                             f"the engine runs on {self.device}")

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
    n_waves) for one scheduled window."""

    def _schedule(self, base_key, start: int, count: int):
        """Create one window of tasks and reduce it to wave levels
        (conflict + levels kernels). Always W tasks: the last window is
        masked by ``valid``, as in the reference, so its schedule
        matches. Returns (recipes, valid, levels), all enqueued on the
        device, none waited for."""
        recipes = self.model.create_tasks(base_key, start, self.window)
        valid = torch.arange(self.window, device=self.device) < count
        conf = window_conflicts(self.model, recipes, valid,
                                strict=self.strict)
        return recipes, valid, wave_levels(conf, valid)

    def _execute(self, state, sched):  # pragma: no cover - abstract
        raise NotImplementedError

    def run(self, state: Any, total_tasks: int, *, seed: int = 0):
        if self.overlap:
            raise ValueError(
                f"engine {self.name!r}: cross-window overlap is not ported "
                "yet; use overlap=False (the barrier loop)")
        self._check_state(state)
        base_key = prng.key(seed, device=self.device)
        t = 0
        n_windows = 0
        total_waves = 0
        nxt = self._schedule(base_key, 0, min(self.window, total_tasks))
        while t < total_tasks:
            k = min(self.window, total_tasks - t)
            cur = nxt
            if t + k < total_tasks:
                # double buffering: enqueue window t+1's schedule (conflict
                # matrix + levels) before window t's waves
                nxt = self._schedule(base_key, t + k,
                                     min(self.window, total_tasks - t - k))
            state, n_waves = self._execute(state, cur)
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
        return state, finalize_stats(stats)

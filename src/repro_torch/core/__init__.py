"""Core of the port: the paper's adaptive-parallelization protocol.

  model.py      — recipe/record model interface (paper §3.5)
  records.py    — vectorized worker records: prefix-conflict matrices,
                  wave levels, the cross-window block and carry frontier
  wavefront.py  — per-window wave execution primitive
  chain.py      — bidirectional task chain (paper §3.3)
  workersim.py  — paper-faithful n-worker discrete-event simulator
  protocol.py   — high-level API

Streaming execution lives behind the engine registry
(``repro_torch.engine``). ``WavefrontRunner`` and ``run_sequential`` come
from there, resolved at first use: the engines import ``core.records``,
so importing them here would make the two packages import each other.
"""
from repro_torch.core.model import MABSModel, footprint_conflicts
from repro_torch.core.protocol import (
    ProtocolConfig,
    run_engine,
    run_oracle,
    run_wavefront,
    simulate_protocol,
)
from repro_torch.core.records import (
    carry_frontier,
    critical_path_length,
    cross_window_conflicts,
    prefix_conflicts,
    wave_levels,
    wave_levels_capped,
    window_conflicts,
)
from repro_torch.core.wavefront import execute_window, window_schedule_stats
from repro_torch.core.workersim import (
    DESCosts,
    DESModel,
    DESResult,
    ProtocolSimulator,
)

__all__ = [
    "run_engine",
    "MABSModel",
    "footprint_conflicts",
    "window_conflicts",
    "cross_window_conflicts",
    "carry_frontier",
    "ProtocolConfig",
    "run_oracle",
    "run_wavefront",
    "prefix_conflicts",
    "wave_levels",
    "wave_levels_capped",
    "critical_path_length",
    "execute_window",
    "window_schedule_stats",
    "simulate_protocol",
    "WavefrontRunner",
    "run_sequential",
    "DESCosts",
    "DESModel",
    "DESResult",
    "ProtocolSimulator",
]


def __getattr__(name):  # PEP 562: the engine registry's names, lazily
    if name in ("WavefrontRunner", "run_sequential"):
        from repro_torch.core import wavefront

        return getattr(wavefront, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

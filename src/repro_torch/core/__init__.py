"""Core of the port: the paper's adaptive-parallelization protocol.

  model.py      — recipe/record model interface (paper §3.5)
  records.py    — vectorized worker records: prefix-conflict matrices,
                  wave levels, the cross-window block and carry frontier
  wavefront.py  — per-window wave execution primitive
  protocol.py   — high-level API

Streaming execution lives behind the engine registry
(``repro_torch.engine``).
"""
from repro_torch.core.model import MABSModel, footprint_conflicts
from repro_torch.core.protocol import (
    ProtocolConfig,
    run_engine,
    run_oracle,
    run_wavefront,
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
]

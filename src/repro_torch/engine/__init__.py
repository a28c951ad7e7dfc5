"""Pluggable execution engines for the wavefront protocol.

  base.py       — ``Engine`` interface, registry, shared windowed loop
  sequential.py — chain-order oracle (``sequential``)
  wavefront.py  — single-device vectorized waves (``wavefront``), and the
                  same with cross-window overlap on
                  (``wavefront_overlap``)
  sharded.py    — waves sharded over the agent axis of a
                  ``torch.distributed`` process group, with the comm
                  ladder: per-wave halo split (``sharded``), monolithic
                  window/pair halo (``sharded_window_halo``), replicated
                  all_gather (``sharded_replicated``), and ``sharded``
                  with cross-window overlap on (``sharded_overlap``)

All engines run the identical task stream and are bit-exact under the
strict hazard rule; pick one by name through ``make_engine`` (or
``ProtocolConfig.engine`` at the ``repro_torch.core`` API level).
"""
from repro_torch.engine.base import (
    ENGINES,
    Engine,
    WindowedEngine,
    get_engine,
    make_engine,
    register_engine,
)
from repro_torch.engine.sequential import SequentialEngine, run_sequential
from repro_torch.engine.sharded import (
    ShardedEngine,
    ShardedOverlapEngine,
    ShardedReplicatedEngine,
    ShardedWindowHaloEngine,
)
from repro_torch.engine.wavefront import (
    WavefrontEngine,
    WavefrontOverlapEngine,
    WavefrontRunner,
)

__all__ = [
    "ENGINES",
    "Engine",
    "WindowedEngine",
    "get_engine",
    "make_engine",
    "register_engine",
    "SequentialEngine",
    "run_sequential",
    "WavefrontEngine",
    "WavefrontOverlapEngine",
    "WavefrontRunner",
    "ShardedEngine",
    "ShardedWindowHaloEngine",
    "ShardedReplicatedEngine",
    "ShardedOverlapEngine",
]

"""High-level protocol API — binds a MABS model to an execution engine.

Port of ``repro/core/protocol.py``. Engines are pluggable
(``repro_torch.engine``): ``sequential`` (the oracle), ``wavefront``
(single-device vectorized waves), ``wavefront_overlap`` (the same with
cross-window overlap), and the sharded engines ``sharded``,
``sharded_window_halo``, ``sharded_replicated`` and ``sharded_overlap``
(waves sharded over the agent axis of a ``torch.distributed`` process
group: pass ``group=``, or initialize the default group, or run a world
of one). All run the identical task stream and are bit-exact against
each other under the strict hazard rule. Entry points run on the card
unless ``device`` names another. ``simulate_protocol`` runs the
paper-faithful discrete-event simulator (core/workersim.py) on a model's
``des_model`` adapter, on the host.

The paper's "choices in applying the protocol" (§3.4) map to:
  chain granularity  -> the model's task definition (e.g. agents per subset)
  task depth         -> what create_tasks precomputes (ids + PRNG binding)
  workflow params    -> n_workers, C (DES); window size + engine choice +
                        cross-window overlap (the windowed engines)
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.workersim import DESCosts, DESModel, ProtocolSimulator


@dataclass
class ProtocolConfig:
    window: int = 256          # recipe-window size (windowed engines)
    n_workers: int = 4         # n  (DES engine)
    tasks_per_cycle: int = 6   # C  (DES engine; paper keeps C=6)
    strict: bool = True        # full hazard closure vs paper's record rule
    engine: str = "wavefront"  # registry name (repro_torch.engine)
    #: cross-window overlap knob: True lets window k+1's head waves ride
    #: into window k's tail drain (record carry-over, engine docs); False
    #: forces the conservative window barrier; None (default) keeps each
    #: engine's own default (``wavefront_overlap`` defaults on, the
    #: others to the barrier)
    overlap: bool | None = None


def run_engine(model, state, total_tasks: int, *, seed: int = 0,
               config: ProtocolConfig | None = None,
               engine: str | None = None, device=None, **engine_kwargs):
    """Run total_tasks through the engine named by ``engine`` (or
    ``config.engine``) on ``device`` (default: the card); extra kwargs go
    to the engine constructor (``overlap=...`` flips the cross-window
    overlap knob, default from config; the sharded engines take
    ``group=``, ``halo=``, ``split=`` and ``chunk=``). Returns (state,
    stats)."""
    import inspect

    from repro_torch.engine import get_engine, make_engine

    cfg = config or ProtocolConfig()
    name = engine or cfg.engine
    if cfg.overlap is not None and "overlap" not in engine_kwargs:
        # inject only into constructors that take the knob: an engine
        # registered without it keeps working for every cfg.overlap
        params = inspect.signature(get_engine(name).__init__).parameters
        if "overlap" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in params.values()):
            engine_kwargs["overlap"] = cfg.overlap
    eng = make_engine(name, model, window=cfg.window,
                      strict=cfg.strict, device=device, **engine_kwargs)
    return eng.run(state, total_tasks, seed=seed)


def run_wavefront(model, state, total_tasks: int, *, seed: int = 0,
                  config: ProtocolConfig | None = None, device=None):
    return run_engine(model, state, total_tasks, seed=seed, config=config,
                      engine="wavefront", device=device)


def run_oracle(model, state, total_tasks: int, *, seed: int = 0,
               config: ProtocolConfig | None = None, device=None):
    from repro_torch.engine.sequential import run_sequential

    cfg = config or ProtocolConfig()
    return run_sequential(model, state, total_tasks, seed=seed,
                          window=cfg.window, device=device)


def simulate_protocol(des_model: DESModel, total_tasks: int, *,
                      config: ProtocolConfig | None = None,
                      costs: DESCosts | None = None):
    """Run ``total_tasks`` through the discrete-event simulator with
    ``config.n_workers`` workers and ``config.tasks_per_cycle`` (C);
    returns its ``DESResult``."""
    cfg = config or ProtocolConfig()
    sim = ProtocolSimulator(
        des_model,
        n_workers=cfg.n_workers,
        total_tasks=total_tasks,
        tasks_per_cycle=cfg.tasks_per_cycle,
        costs=costs,
    )
    return sim.run()

"""Observability for the port: protocol tracing, stats and provenance.

  trace.py      — structured span tracer: per-window, per-wave and
                  per-boundary events exported as Chrome trace-event JSON
                  (Perfetto-loadable). Off by default; the engines' loops
                  gain no op and no host sync when no tracer is installed.
  stats.py      — typed, versioned stats registry: every engine stat is
                  declared once (kind, group, description); ``run`` stats
                  are validated against it and normalized to host-native
                  Python scalars.
  profiler.py   — ``torch.profiler`` integration: ``profile_session`` and
                  the ``annotate`` ranges that label the protocol phases.
  provenance.py — environment header (torch and CUDA versions, backend,
                  device kind and count, power limit, timestamp, git sha).
  costs.py      — cost telemetry of one executed window executor: FLOPs,
                  bytes accessed, the memory decomposition, the
                  collectives by call site and loop depth, and the cross-
                  check against the sharded engines' comm ledger
                  (``Engine.compiled_costs``); the recorder the loops,
                  collective call sites and kernel wrappers report to.
"""
from repro_torch.obs.costs import (
    CrossCheck,
    ExecutorCost,
    HloCollectives,
    current_recorder,
    executor_cost,
    ledger_cross_check,
    parse_collectives,
    recording,
)
from repro_torch.obs.provenance import provenance
from repro_torch.obs.stats import (
    STATS_VERSION,
    StatSpec,
    finalize_stats,
    registry,
    row_keys,
)
from repro_torch.obs.trace import (
    SpanTracer,
    current_tracer,
    tracing,
    validate_chrome_trace,
)

__all__ = [
    "SpanTracer",
    "current_tracer",
    "tracing",
    "validate_chrome_trace",
    "StatSpec",
    "STATS_VERSION",
    "finalize_stats",
    "registry",
    "row_keys",
    "provenance",
    "ExecutorCost",
    "HloCollectives",
    "CrossCheck",
    "executor_cost",
    "parse_collectives",
    "ledger_cross_check",
    "current_recorder",
    "recording",
]

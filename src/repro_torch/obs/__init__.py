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

The reference's compiled-cost telemetry (``obs/costs.py``) parses XLA
HLO; it comes with the sharded engines.
"""
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
]

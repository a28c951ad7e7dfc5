"""Observability for the port: so far the typed engine-stats registry
(``stats.py``); the span tracer and profiler scopes come later."""
from repro_torch.obs.stats import STATS_VERSION, finalize_stats

__all__ = ["STATS_VERSION", "finalize_stats"]

"""Typed, versioned engine-stats registry.

The port's own copy of ``repro/obs/stats.py`` (the port imports nothing of
the JAX package): the registry, ``finalize_stats`` and the declarations
the ported engines emit, under the same keys, kinds and
``STATS_VERSION``, so a port run's stats dict equals the reference's.

``finalize_stats`` (called by every engine on its way out of ``run``)
rejects undeclared keys and converts every value to a host-native Python
scalar, so no 0-d tensor leaks into a result.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping

#: the reference's version of the declarations copied here
STATS_VERSION = 2

#: declaration groups, in rendering order
GROUPS = ("core", "device", "comm", "overlap", "serving")


@dataclass(frozen=True)
class StatSpec:
    key: str
    kind: str          # "int" | "float" | "bool" | "mapping"
    group: str         # one of GROUPS
    description: str
    nullable: bool = False

    def normalize(self, value: Any) -> Any:
        """Coerce one stat value to its declared host-native type."""
        if value is None:
            if self.nullable:
                return None
            raise ValueError(f"stat {self.key!r} is not nullable")
        if self.kind in ("int", "float"):
            v = float(value)
            if not math.isfinite(v):
                raise ValueError(
                    f"stat {self.key!r} is non-finite ({v!r}) — refusing "
                    "to record it")
            return int(value) if self.kind == "int" else v
        if self.kind == "bool":
            return bool(value)
        if self.kind == "mapping":
            if not isinstance(value, Mapping):
                raise ValueError(
                    f"stat {self.key!r} expects a mapping, got "
                    f"{type(value).__name__}")
            return {str(k): int(v) for k, v in value.items()}
        raise ValueError(f"unknown stat kind {self.kind!r}")


_REGISTRY: dict[str, StatSpec] = {}


def declare(key: str, kind: str, group: str, description: str, *,
            nullable: bool = False) -> StatSpec:
    if group not in GROUPS:
        raise ValueError(f"unknown stats group {group!r}")
    if key in _REGISTRY:
        raise ValueError(f"stat {key!r} declared twice")
    spec = StatSpec(key, kind, group, description, nullable)
    _REGISTRY[key] = spec
    return spec


def finalize_stats(stats: dict) -> dict:
    """Validate + normalize one engine ``run`` stats dict: every key must
    be declared, and every value is converted to its declared host-native
    Python type."""
    out: dict = {}
    for key, value in stats.items():
        spec = _REGISTRY.get(key)
        if spec is None:
            raise ValueError(
                f"undeclared engine stat {key!r} — declare it in "
                f"repro_torch/obs/stats.py")
        out[key] = spec.normalize(value)
    return out


# --------------------------------------------------------------------------
# the declarations the ported engines emit

# core — every engine
declare("total_tasks", "int", "core", "tasks executed from the chain")
declare("n_windows", "int", "core", "windows the chain was cut into")
declare("total_waves", "int", "core",
        "executed (fused) waves over the whole run")
declare("mean_parallelism", "float", "core",
        "total_tasks / total_waves — mean tasks per wave")

# overlap — windowed engines (the cross-window carry-over accounting)
declare("overlap", "bool", "overlap",
        "the overlapped (fused-boundary) loop actually ran",
        nullable=True)
declare("n_boundaries", "int", "overlap",
        "window transitions checked (n_windows - 1)", nullable=True)
declare("mean_overlap_depth", "float", "overlap",
        "mean tail waves of window k that also ran window k+1 tasks",
        nullable=True)
declare("max_overlap_depth", "int", "overlap",
        "max of the same over boundaries", nullable=True)
declare("overlap_tasks_early", "int", "overlap",
        "tasks executed before their window's barrier would have opened",
        nullable=True)
declare("carry_frontier_mean", "float", "overlap",
        "mean carry floor over next-window tasks (0 = independent head)",
        nullable=True)
declare("carry_frontier_max", "int", "overlap",
        "largest carry floor seen", nullable=True)

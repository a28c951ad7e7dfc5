"""Typed, versioned engine-stats registry.

The port's own copy of ``repro/obs/stats.py`` (the port imports nothing of
the JAX package): every statistic an engine may emit from ``run`` is
declared here once — key, kind, group, nullability and a one-line
meaning — under the reference's keys, groups, descriptions and
``STATS_VERSION``, so a port run's stats dict equals the reference's.
The ``device``, ``comm`` and ``serving`` keys belong to engines the port
has not reached yet (the sharded engines, serving); they are declared
now so that the two registries stay equal.

  * ``finalize_stats`` (called by every engine on its way out of ``run``)
    rejects undeclared keys (unless ``strict=False``) and converts every
    value to a host-native Python scalar, so no 0-d tensor leaks into a
    result;
  * ``row_keys(group, ...)`` gives the declared keys of the groups in
    declaration order, a derived row schema.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping

#: bump on any change to the declared keys or their meaning (the
#: reference's version of the declarations copied here)
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


def registry() -> Mapping[str, StatSpec]:
    """The full declaration table (read-only view by convention)."""
    return _REGISTRY


def row_keys(*groups: str) -> tuple[str, ...]:
    """Declared keys of the given groups (all groups when empty), in
    declaration order."""
    want = groups or GROUPS
    for g in want:
        if g not in GROUPS:
            raise ValueError(f"unknown stats group {g!r}")
    return tuple(s.key for s in _REGISTRY.values() if s.group in want)


def finalize_stats(stats: dict, *, strict: bool = True) -> dict:
    """Validate + normalize one engine ``run`` stats dict: every key must
    be declared (unless ``strict=False``, which passes unknown keys
    through as they are), and every declared value is converted to its
    declared host-native Python type."""
    out: dict = {}
    for key, value in stats.items():
        spec = _REGISTRY.get(key)
        if spec is None:
            if strict:
                raise ValueError(
                    f"undeclared engine stat {key!r} — declare it in "
                    f"repro_torch/obs/stats.py (and bump STATS_VERSION)")
            out[key] = value
            continue
        out[key] = spec.normalize(value)
    return out


# --------------------------------------------------------------------------
# the declarations (the reference's, in its order)

# core — every engine
declare("total_tasks", "int", "core", "tasks executed from the chain")
declare("n_windows", "int", "core", "windows the chain was cut into")
declare("total_waves", "int", "core",
        "executed (fused) waves over the whole run")
declare("mean_parallelism", "float", "core",
        "total_tasks / total_waves — mean tasks per wave")

# device — sharded engines
declare("n_devices", "int", "device", "mesh size over the agent axis")

# comm — sharded engines (all byte counts are per-device receive volume)
declare("halo", "bool", "comm", "some window used a halo layout "
        "(split, window or pair halo)", nullable=True)
declare("halo_split", "bool", "comm",
        "some window used the per-wave split rung", nullable=True)
declare("comm_modes", "mapping", "comm",
        "executed windows per comm-ladder rung, e.g. {'split': 5}",
        nullable=True)
declare("per_wave_gather_rows", "int", "comm",
        "mean rows shipped per executed wave", nullable=True)
declare("per_wave_comm_bytes", "int", "comm",
        "mean bytes shipped per executed wave", nullable=True)
declare("per_wave_split_rows", "float", "comm",
        "mean split-slab rows per wave (None when the split didn't run)",
        nullable=True)
declare("window_halo_rows", "int", "comm",
        "monolithic window/pair-halo reference rows per wave "
        "(padded N where that rung would replicate)", nullable=True)
declare("window_halo_bytes", "int", "comm",
        "the same reference in bytes", nullable=True)
declare("comm_reduction_vs_window_halo", "float", "comm",
        "window_halo_bytes / per_wave_comm_bytes — the split's win "
        "(1.0 on the monolithic rung)", nullable=True)
declare("full_state_bytes", "int", "comm",
        "replicated all_gather baseline bytes per wave", nullable=True)
declare("comm_bytes_total", "int", "comm",
        "rows actually shipped over the whole run, in bytes",
        nullable=True)

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

# serving — the reference's continuous-batching engine; its waves are
# protocol iterations, so the core keys apply unchanged
declare("serving_prefill_tasks", "int", "serving",
        "prefill-chunk tasks executed", nullable=True)
declare("serving_decode_tasks", "int", "serving",
        "decode-step tasks executed (batched per wave)", nullable=True)
declare("serving_requests_finished", "int", "serving",
        "requests completed (EOS or max_new_tokens)", nullable=True)

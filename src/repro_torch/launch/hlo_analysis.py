"""The collective model of the roofline report.

Port of ``repro/launch/hlo_analysis.py``. The reference reads every
collective from the compiled HLO text (``compiled.as_text()``): its
per-device result bytes, its replica-group size and the trip counts of
the ``while`` loops around it. The port has no compiled program. It
measures **one executed call** instead: the collective call sites report
each collective they issue to the installed cost recorder
(``obs/costs.py``), with the loop context they run in, into a
``CollectiveTrace``. So where the reference counts a loop body once and
multiplies by the trip count it can recover from the loop's condition
(or by 1, when the trip count is data-dependent), the port counts what it
executes, every wave included: its counts are loop-adjusted by
construction.

Wire-cost model per op (ring algorithms, n = group participants), the
reference's table, which ``distributed/collectives.py`` shares:
  all-reduce       2·(n-1)/n · bytes
  all-gather /
  reduce-scatter   (n-1)/n · bytes
  all-to-all       (n-1)/n · bytes
  collective-permute   1.0 · bytes

``parse_computations``, ``trip_count``, ``loop_adjusted_flops`` and the
reference's regexes read only HLO text. They have no counterpart by
nature, as ``utils/compat.py`` (which shims JAX's own API names) has none.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from fractions import Fraction

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}


def _shape_bytes(type_str: str) -> int:
    """Bytes of an HLO-style type string: ``f32[16]``, ``u8[64,4]``, or a
    tuple of them ``(f32[4], s32[])``; unknown element types count 0."""
    total = 0
    for dt, dims in re.findall(r"([a-z0-9]+)\[([\d,]*)\]", type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


_WIRE_FACTOR = {
    "all-reduce": lambda n: 2 * (n - 1) / max(n, 1),
    "all-gather": lambda n: (n - 1) / max(n, 1),
    "reduce-scatter": lambda n: (n - 1) / max(n, 1),
    "all-to-all": lambda n: (n - 1) / max(n, 1),
    "collective-permute": lambda n: 1.0,
}


@dataclass
class CollectiveStats:
    raw_bytes: dict = field(default_factory=dict)        # opcode -> bytes ×1
    loop_bytes: dict = field(default_factory=dict)       # × trip counts
    wire_bytes: dict = field(default_factory=dict)       # ring-cost adjusted
    count: dict = field(default_factory=dict)
    unknown_trip_whiles: int = 0

    def total_wire(self) -> float:
        return float(sum(self.wire_bytes.values()))

    def total_loop(self) -> float:
        return float(sum(self.loop_bytes.values()))


def analyze_collectives(trace) -> CollectiveStats:
    """Per-op totals of one executed program (a ``CollectiveTrace``):

      loop_bytes  every execution: each collective's result bytes × its
                  units × the executions its record stands for
                  (``repeat``: a replayed loop's trips; the whole step);
      raw_bytes   one iteration of every loop of known trip count: each
                  execution over its static multiplier (one layer body,
                  one microbatch). A data-dependent loop's trips are
                  executed, not known, so its collectives count at every
                  trip (the reference counts such a loop once);
      wire_bytes  loop bytes × the ring factor of the op's group;
      count       the collectives in ``raw_bytes``' terms (units over
                  static multipliers);
      unknown_trip_whiles  the data-dependent loops entered (by site).

    A collective issued after a loop, outside it (the backward pass of
    a layer loop, say), is not in the loop's context and counts whole in
    ``raw_bytes`` too."""
    stats = CollectiveStats()
    for e in trace.events:
        executed = e.nbytes * e.units * e.repeat
        stats.raw_bytes[e.op] = (stats.raw_bytes.get(e.op, 0)
                                 + Fraction(executed, e.static_mult))
        stats.loop_bytes[e.op] = stats.loop_bytes.get(e.op, 0) + executed
        stats.wire_bytes[e.op] = (stats.wire_bytes.get(e.op, 0.0)
                                  + executed * _WIRE_FACTOR[e.op](
                                      e.group_size or 2))
        stats.count[e.op] = (stats.count.get(e.op, 0)
                             + Fraction(e.units * e.repeat, e.static_mult))
    for d in (stats.raw_bytes, stats.count):
        for op, v in d.items():
            d[op] = int(v) if v.denominator == 1 else float(v)
    stats.unknown_trip_whiles = len(trace.dynamic_loops)
    return stats

"""Structured span tracer for the wavefront protocol.

The port's own copy of ``repro/obs/trace.py``, with the same span
taxonomy, PID/TID layout, thread names and Chrome trace-event JSON (the
``{"traceEvents": [...]}`` format Perfetto and ``chrome://tracing`` load).
It records *where wall-clock time goes* per window, wave and boundary.

* **Off by default, zero hot-path cost.** No tracer is installed unless
  the caller enters ``tracing()``; the engines check ``current_tracer()
  is None`` once per run and skip every trace branch then, so the
  untraced loops gain no op and no host sync.
* **Fenced host timestamps.** With tracing on, the engines fence the
  device work of each span (``utils.timing.block_all``:
  ``torch.cuda.synchronize`` for CUDA tensors) before it closes, so a
  span's duration is real host + device wall time. This serializes the
  double-buffered window pipeline on purpose: tracing trades throughput
  for attribution.
* **Per-wave spans are attributed.** The window's measured execute span
  is subdivided in proportion to wave width, each wave span marked
  ``"attributed": true`` — as in the reference, whose waves run inside a
  device loop the host cannot see. The port loops waves on the host and
  could time each one, but keeps the reference's attribution so that a
  port trace and a reference trace of the same run carry the same args.
  Device-accurate per-phase timing comes from ``obs/profiler.py``'s
  ``protocol.*`` ranges under ``torch.profiler``.

Span taxonomy (all under pid 1, process "repro.protocol"):

  tid 0 "windows"  — B/E spans: ``run`` (whole engine run), ``schedule``
                     (one window's creation + conflict + levels),
                     ``execute`` (one window's wave drain), ``boundary``
                     (overlap carry step: cross block + frontier +
                     re-level).
  tid 1 "waves"    — X spans: one ``wave`` per executed (fused) wave,
                     width-proportional attribution inside its window.
  tid 2 "comm"     — X spans: ``halo_gather`` per wave that shipped rows
                     (the sharded engines; none on one device).

Usage:

    from repro_torch.obs import tracing

    with tracing() as tr:
        state, stats = engine.run(state, total)
    tr.export("trace.json")           # -> load in ui.perfetto.dev
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Any

#: Chrome trace-event phases the tracer emits / the validator accepts.
PHASES = frozenset({"B", "E", "X", "i", "I", "C", "M"})

PID = 1
TID_WINDOWS = 0
TID_WAVES = 1
TID_COMM = 2

_THREAD_NAMES = {TID_WINDOWS: "windows", TID_WAVES: "waves",
                 TID_COMM: "comm"}


class Span:
    """An open (or closed) B/E span; ``args`` may be extended until
    export — the engines attach outputs that only exist after the fence
    (e.g. the executed wave count) to an already-entered span."""

    __slots__ = ("name", "cat", "tid", "args", "t0", "t1")

    def __init__(self, name: str, cat: str, tid: int, args: dict):
        self.name = name
        self.cat = cat
        self.tid = tid
        self.args = args
        self.t0: float = 0.0
        self.t1: float | None = None


class SpanTracer:
    """Collects trace events in memory; export renders Chrome JSON.

    Not thread-safe by design: the engines' run loops are single-
    threaded hosts, and the tracer is installed per ``tracing()`` block.
    """

    def __init__(self, *, process_name: str = "repro.protocol"):
        self.process_name = process_name
        self._spans: list[Span] = []          # closed + open B/E spans
        self._events: list[dict] = []         # X / i / C events
        self._stack: list[Span] = []          # open spans (tid 0 only)
        self._epoch = time.perf_counter()

    # ------------------------------------------------------------ clock
    def _now_us(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e6

    # ------------------------------------------------------------ spans
    @contextmanager
    def span(self, name: str, *, cat: str = "protocol",
             tid: int = TID_WINDOWS, **args: Any):
        """B/E span around a block. The yielded ``Span`` exposes ``args``
        (mutable until export) and, after exit, ``t0``/``t1`` in µs —
        ``subdivide`` uses them to attribute child wave spans. The caller
        is responsible for fencing device work inside the block (the
        engines call ``utils.timing.block_all`` before exiting) so the
        recorded duration is real wall time."""
        sp = Span(name, cat, tid, dict(args))
        sp.t0 = self._now_us()
        self._stack.append(sp)
        self._spans.append(sp)
        try:
            yield sp
        finally:
            sp.t1 = self._now_us()
            self._stack.pop()

    def instant(self, name: str, *, cat: str = "protocol",
                tid: int = TID_WINDOWS, **args: Any) -> None:
        self._events.append({"name": name, "ph": "i", "cat": cat,
                             "ts": self._now_us(), "pid": PID, "tid": tid,
                             "s": "t", "args": args})

    def complete(self, name: str, ts_us: float, dur_us: float, *,
                 cat: str = "protocol", tid: int = TID_WAVES,
                 **args: Any) -> None:
        """X (complete) event with explicit timestamps."""
        self._events.append({"name": name, "ph": "X", "cat": cat,
                             "ts": float(ts_us), "dur": float(dur_us),
                             "pid": PID, "tid": tid, "args": args})

    def subdivide(self, parent: Span, name: str, weights, args_list, *,
                  tid: int = TID_WAVES, cat: str = "protocol",
                  ) -> list[tuple[float, float]]:
        """Attribute ``parent``'s measured duration to child X spans in
        proportion to ``weights`` (the engines pass wave widths — see the
        module docstring for why per-wave timing is attribution, not
        measurement). ``args_list[i]`` extends child i's args. Returns
        the children's (ts, dur) slots so the caller can align further
        events (e.g. per-wave halo-gather spans) with them."""
        if parent.t1 is None:
            raise ValueError("subdivide() needs a closed span")
        total = float(sum(weights)) or 1.0
        dur = parent.t1 - parent.t0
        t = parent.t0
        slots: list[tuple[float, float]] = []
        for i, (wgt, extra) in enumerate(zip(weights, args_list)):
            d = dur * float(wgt) / total
            self.complete(name, t, d, tid=tid, cat=cat,
                          index=i, attributed=True, **extra)
            slots.append((t, d))
            t += d
        return slots

    # ----------------------------------------------------------- export
    def events(self) -> list[dict]:
        """Render every recorded event as a Chrome trace-event dict."""
        out: list[dict] = [
            {"name": "process_name", "ph": "M", "pid": PID, "tid": 0,
             "args": {"name": self.process_name}},
        ]
        for tid, tname in _THREAD_NAMES.items():
            out.append({"name": "thread_name", "ph": "M", "pid": PID,
                        "tid": tid, "args": {"name": tname}})
        for sp in self._spans:
            out.append({"name": sp.name, "ph": "B", "cat": sp.cat,
                        "ts": sp.t0, "pid": PID, "tid": sp.tid,
                        "args": dict(sp.args)})
            out.append({"name": sp.name, "ph": "E", "cat": sp.cat,
                        "ts": sp.t1 if sp.t1 is not None else self._now_us(),
                        "pid": PID, "tid": sp.tid})
        out.extend(self._events)
        # stable ts order (ties keep emission order, so an E at the same
        # timestamp as the next B stays correctly nested)
        out.sort(key=lambda e: e.get("ts", 0.0))
        return out

    def to_chrome_trace(self) -> dict:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms",
                "otherData": {"tracer": "repro_torch.obs", "version": 1}}

    def export(self, path: str | None = None) -> dict:
        """Chrome trace-event payload; also written to ``path`` if given."""
        payload = self.to_chrome_trace()
        if path is not None:
            with open(path, "w") as f:
                json.dump(payload, f)
        return payload

    def __len__(self) -> int:
        return 2 * len(self._spans) + len(self._events)


# --------------------------------------------------------------------------
# the installed tracer (module global; None = tracing off, the default)

_CURRENT: SpanTracer | None = None


def current_tracer() -> SpanTracer | None:
    """The installed tracer, or None (the default: tracing off). Engines
    check this exactly once per run and skip every trace branch when it
    is None — the untraced hot path stays sync-free."""
    return _CURRENT


@contextmanager
def tracing(tracer: SpanTracer | None = None):
    """Install a tracer for the duration of the block (and restore the
    previous one after — blocks nest)."""
    global _CURRENT
    prev = _CURRENT
    tr = tracer if tracer is not None else SpanTracer()
    _CURRENT = tr
    try:
        yield tr
    finally:
        _CURRENT = prev


# --------------------------------------------------------------------------
# schema validation (tests + chip_smoke.py's traced run)

def validate_chrome_trace(payload: Any) -> int:
    """Validate a Chrome trace-event payload; returns the event count.

    Checks the invariants the tests and chip_smoke.py's traced run pin:
      * top level is ``{"traceEvents": [...]}`` (or a bare event list);
      * every event carries name/ph/pid/tid, a known phase, and a
        non-negative ``ts`` (metadata ``M`` events are exempt from ts);
      * ``X`` events carry a non-negative ``dur``;
      * per (pid, tid), in timestamp order, ``B``/``E`` events form a
        properly nested stack with matching names and non-decreasing
        timestamps (every span closed, no cross-nesting).

    Raises ``ValueError`` on the first violation.
    """
    if isinstance(payload, dict):
        events = payload.get("traceEvents")
        if not isinstance(events, list):
            raise ValueError("payload has no traceEvents list")
    elif isinstance(payload, list):
        events = payload
    else:
        raise ValueError(f"not a trace payload: {type(payload).__name__}")

    lanes: dict[tuple, list[dict]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        for k in ("name", "ph", "pid", "tid"):
            if k not in ev:
                raise ValueError(f"event {i} ({ev.get('name')!r}) "
                                 f"missing {k!r}")
        ph = ev["ph"]
        if ph not in PHASES:
            raise ValueError(f"event {i} ({ev['name']!r}) has unknown "
                             f"phase {ph!r}")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"event {i} ({ev['name']!r}) has bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"X event {i} ({ev['name']!r}) has bad "
                                 f"dur {dur!r}")
        lanes.setdefault((ev["pid"], ev["tid"]), []).append(ev)

    for (pid, tid), lane in lanes.items():
        lane = sorted(lane, key=lambda e: e["ts"])  # stable: ties keep order
        stack: list[dict] = []
        last_ts = 0.0
        for ev in lane:
            if ev["ts"] < last_ts:
                raise ValueError(
                    f"tid {tid}: timestamps regress at {ev['name']!r}")
            last_ts = ev["ts"]
            if ev["ph"] == "B":
                stack.append(ev)
            elif ev["ph"] == "E":
                if not stack:
                    raise ValueError(
                        f"tid {tid}: E {ev['name']!r} without open B")
                top = stack.pop()
                if top["name"] != ev["name"]:
                    raise ValueError(
                        f"tid {tid}: E {ev['name']!r} closes B "
                        f"{top['name']!r} (cross-nested spans)")
        if stack:
            raise ValueError(
                f"tid {tid}: {len(stack)} unclosed span(s), first open: "
                f"{stack[0]['name']!r}")
    return len(events)

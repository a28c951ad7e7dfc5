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
  Measured per-phase timing comes from the layer spans (tid 3) and from
  ``obs/profiler.py``'s ``protocol.*`` ranges under ``torch.profiler``.

Span taxonomy (all under pid 1, process "repro.protocol"):

  tid 0 "windows"  — B/E spans: ``run`` (whole engine run), ``schedule``
                     (one window's creation + conflict + levels),
                     ``execute`` (one window's wave drain), ``boundary``
                     (overlap carry step: cross block + frontier +
                     re-level); each also opens the profiler range
                     ``protocol.<name>``.
  tid 1 "waves"    — X spans: one ``wave`` per executed (fused) wave,
                     width-proportional attribution inside its window.
  tid 2 "comm"     — X spans: ``halo_gather`` per wave that shipped rows
                     (the sharded engines; none on one device).
  tid 3 "layers"   — X spans: one per ``obs.profiler.annotate`` range
                     entered while the tracer is installed (creation, the
                     record check, the levels, each wave, its draws, its
                     wave kernel, its ``scatter_rows``), named as the
                     range; args ``window`` (the ``index`` of the
                     innermost open window span), ``wave`` where one
                     applies and, on the card, ``device_ms``: the stream
                     time between two CUDA timing events recorded at entry
                     and exit, read after the run (``resolve``), never by a
                     sync inside the loop. Layer spans are not fenced.

**One clock with torch.profiler.** Timestamps are µs since ``epoch_ns``,
the tracer's creation on the clock ``torch.profiler`` stamps its events
with (Unix time in ns, ``time.time_ns``). ``export(base_ns=...)`` counts
them from a profile's base instead (its ``trace_start_ns`` for the time
ranges of ``prof.events()``, its ``baseTimeNanoseconds`` for its Chrome
export), so the tracer's events and the profile's overlay in Perfetto;
``otherData["epoch_ns"]`` records the Unix ns the export counts from.

**Totals.** Each tracer sums a count, host ms and device ms for each layer
span name, and counts the windows it covered (closed ``execute`` spans).
Every ``tracing()`` block adds its tracer's sums into the process-wide
``layer_totals()`` when it exits, until ``reset_layer_totals()``; the
benchmark's per-layer readers read those. On the CPU a layer's device ms
is its host ms.

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

import torch
from torch.autograd import profiler as _autograd_profiler

#: Chrome trace-event phases the tracer emits / the validator accepts.
PHASES = frozenset({"B", "E", "X", "i", "I", "C", "M"})

PID = 1
TID_WINDOWS = 0
TID_WAVES = 1
TID_COMM = 2
TID_LAYERS = 3

_THREAD_NAMES = {TID_WINDOWS: "windows", TID_WAVES: "waves",
                 TID_COMM: "comm", TID_LAYERS: "layers"}


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


class Layer:
    """One layer span (tid 3): host µs, its window and wave, and on the
    card the CUDA events whose stream time ``resolve`` reads."""

    __slots__ = ("name", "window", "wave", "t0", "t1", "ev0", "ev1",
                 "device_ms")

    def __init__(self, name: str, window, wave):
        self.name = name
        self.window = window
        self.wave = wave
        self.t0 = 0.0
        self.t1: float | None = None
        self.ev0 = self.ev1 = None
        self.device_ms: float | None = None


class SpanTracer:
    """Collects trace events in memory; export renders Chrome JSON.

    Not thread-safe by design: the engines' run loops are single-
    threaded hosts, and the tracer is installed per ``tracing()`` block.
    """

    def __init__(self, *, process_name: str = "repro.protocol"):
        self.process_name = process_name
        self._spans: list[Span] = []          # closed + open B/E spans
        self._events: list[dict] = []         # X / C events
        self._stack: list[Span] = []          # open spans (tid 0 only)
        self._layers: list[Layer] = []        # closed + open layer spans
        self._open: list[Layer] = []          # open layer spans
        self._windows = 0                     # closed execute spans
        self._flushed = (0, 0)                # (layers, windows) in totals
        # time layer spans with CUDA events wherever a card is visible
        self._device_events = torch.cuda.is_available()
        self.epoch_ns = time.time_ns()

    # ------------------------------------------------------------ clock
    def _now_us(self) -> float:
        return (time.time_ns() - self.epoch_ns) / 1e3

    # ------------------------------------------------------------ spans
    @contextmanager
    def span(self, name: str, *, cat: str = "protocol",
             tid: int = TID_WINDOWS, **args: Any):
        """B/E span around a block. The yielded ``Span`` exposes ``args``
        (mutable until export) and, after exit, ``t0``/``t1`` in µs —
        ``subdivide`` uses them to attribute child wave spans. The caller
        is responsible for fencing device work inside the block (the
        engines call ``utils.timing.block_all`` before exiting) so the
        recorded duration is real wall time. While ``torch.profiler``
        records, the span also opens the range ``protocol.<name>``, whose
        ends enclose the span's."""
        sp = Span(name, cat, tid, dict(args))
        rf = (torch.profiler.record_function(f"protocol.{name}")
              if _autograd_profiler._is_profiler_enabled else None)
        if rf is not None:
            rf.__enter__()
        sp.t0 = self._now_us()
        self._stack.append(sp)
        self._spans.append(sp)
        try:
            yield sp
        finally:
            sp.t1 = self._now_us()
            self._stack.pop()
            if name == "execute":
                self._windows += 1
            if rf is not None:
                rf.__exit__(None, None, None)

    # ------------------------------------------------------- layer spans
    def open_layer(self, name: str, wave: int | None = None) -> Layer:
        """Enter a layer span (``obs.profiler.annotate`` calls this). Its
        window is the innermost open window span's ``index``; its wave is
        ``wave``, else the innermost open layer span's."""
        if wave is None and self._open:
            wave = self._open[-1].wave
        window = next((sp.args["index"] for sp in reversed(self._stack)
                       if "index" in sp.args), None)
        ly = Layer(name, window, wave)
        if self._device_events:
            ly.ev0 = torch.cuda.Event(enable_timing=True)
            ly.ev0.record()
        ly.t0 = self._now_us()
        self._open.append(ly)
        self._layers.append(ly)
        return ly

    def close_layer(self, ly: Layer) -> None:
        ly.t1 = self._now_us()
        if ly.ev0 is not None:
            ly.ev1 = torch.cuda.Event(enable_timing=True)
            ly.ev1.record()
        else:
            ly.device_ms = (ly.t1 - ly.t0) / 1e3
        self._open.pop()

    def resolve(self) -> None:
        """Read the device ms of every closed layer span: waits for each
        end event, so call it after the run (``tracing()`` does when its
        block exits; ``events`` and ``totals`` do)."""
        for ly in self._layers:
            if ly.ev1 is not None:
                ly.ev1.synchronize()
                ly.device_ms = ly.ev0.elapsed_time(ly.ev1)
                ly.ev0 = ly.ev1 = None

    def totals(self, since: tuple[int, int] = (0, 0)) -> dict:
        """``{"windows": n, "spans": {name: {"count", "host_ms",
        "device_ms"}}}`` over the closed layer spans and execute spans
        after the first ``since`` of each."""
        self.resolve()
        spans: dict[str, dict] = {}
        for ly in self._layers[since[0]:]:
            if ly.t1 is None:
                continue
            s = spans.setdefault(ly.name, {"count": 0, "host_ms": 0.0,
                                           "device_ms": 0.0})
            s["count"] += 1
            s["host_ms"] += (ly.t1 - ly.t0) / 1e3
            s["device_ms"] += ly.device_ms
        return {"windows": self._windows - since[1], "spans": spans}

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
    def events(self, base_ns: int | None = None) -> list[dict]:
        """Render every recorded event as a Chrome trace-event dict, in µs
        since ``base_ns`` (default: the tracer's ``epoch_ns``)."""
        self.resolve()
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
        for ly in self._layers:
            if ly.t1 is None:
                continue
            args = {"window": ly.window}
            if ly.wave is not None:
                args["wave"] = ly.wave
            if self._device_events:
                args["device_ms"] = ly.device_ms
            out.append({"name": ly.name, "ph": "X", "cat": "layer",
                        "ts": ly.t0, "dur": ly.t1 - ly.t0, "pid": PID,
                        "tid": TID_LAYERS, "args": args})
        if base_ns is not None:
            shift = (self.epoch_ns - base_ns) / 1e3
            out = [dict(e, ts=e["ts"] + shift) if "ts" in e else e
                   for e in out]
        # stable ts order (ties keep emission order, so an E at the same
        # timestamp as the next B stays correctly nested)
        out.sort(key=lambda e: e.get("ts", 0.0))
        return out

    def to_chrome_trace(self, base_ns: int | None = None) -> dict:
        return {"traceEvents": self.events(base_ns), "displayTimeUnit": "ms",
                "otherData": {"tracer": "repro_torch.obs", "version": 2,
                              "clock": "unix_ns",
                              "epoch_ns": (self.epoch_ns if base_ns is None
                                           else base_ns)}}

    def export(self, path: str | None = None, *,
               base_ns: int | None = None) -> dict:
        """Chrome trace-event payload; also written to ``path`` if given.
        ``base_ns`` rebases the timestamps onto a profile's base (module
        docstring)."""
        payload = self.to_chrome_trace(base_ns)
        if path is not None:
            with open(path, "w") as f:
                json.dump(payload, f)
        return payload

    def __len__(self) -> int:
        return (2 * len(self._spans) + len(self._events)
                + sum(ly.t1 is not None for ly in self._layers))


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
    previous one after — blocks nest). On exit the tracer's layer spans
    are resolved and what the block added is summed into
    ``layer_totals()``."""
    global _CURRENT
    prev = _CURRENT
    tr = tracer if tracer is not None else SpanTracer()
    _CURRENT = tr
    try:
        yield tr
    finally:
        _CURRENT = prev
        _add_totals(tr.totals(tr._flushed))
        tr._flushed = (len(tr._layers), tr._windows)


# --------------------------------------------------------------------------
# process-wide totals of the tracing() blocks (the benchmark reads these)

_TOTALS: dict = {"windows": 0, "spans": {}}


def _add_totals(t: dict) -> None:
    _TOTALS["windows"] += t["windows"]
    for name, s in t["spans"].items():
        acc = _TOTALS["spans"].setdefault(
            name, {"count": 0, "host_ms": 0.0, "device_ms": 0.0})
        for k, v in s.items():
            acc[k] += v


def layer_totals() -> dict:
    """Sums over every ``tracing()`` block since import or the last
    ``reset_layer_totals()``: ``{"windows": n, "spans": {name: {"count",
    "host_ms", "device_ms"}}}`` (a copy)."""
    return {"windows": _TOTALS["windows"],
            "spans": {k: dict(v) for k, v in _TOTALS["spans"].items()}}


def reset_layer_totals() -> None:
    _TOTALS["windows"] = 0
    _TOTALS["spans"].clear()


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

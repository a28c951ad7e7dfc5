"""One run of one cell: set-up, the measured window or the traced
stretches, the check against the plain reference, and the result line.

The window is whole ``run_engine`` calls back to back on one chained
state, each ending in ``torch.cuda.synchronize()``, until ``seconds``
have passed; call ``i`` draws its tasks from ``call_seed(seed, i)``.
``--trace 1`` replaces the window by stretches of such calls, in this
order: one under torch's sync debug mode (tracing off), calls under the
port's span tracer until ``seconds`` have passed, and calls under
``torch.profiler`` (``_profiled_call``). Every call of either kind is
judged: once the program is done, the reference runs the same calls from
the same initial state, and the final states must be equal.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
#: top-level module names no run may hold once its window has closed
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
#: torch's text for each host sync under ``set_sync_debug_mode("warn")``
SYNC_WARNING = "called a synchronizing CUDA operation"
#: profiler ranges that label idle gaps: the port's and the harness's
RANGE_PREFIXES = ("protocol.", "bench.")


class IncompleteTrace(RuntimeError):
    """The profiler recorded fewer launches of a kernel than the port's
    counters saw."""


def call_seed(seed: int, i: int) -> int:
    """The 32-bit seed of call ``i`` of a run (``i = -1``: the warm-up)."""
    return (int(seed) * 2654435761 + i + 1) & 0xFFFFFFFF


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def state_mismatch(got: dict, want: dict) -> int:
    """State elements of ``want`` that ``got`` does not hold equal (every
    element of a leaf missing or of another shape or dtype)."""
    out = 0
    for k, w in want.items():
        g = got.get(k)
        if g is None or g.shape != w.shape or g.dtype != w.dtype:
            out += w.numel()
        else:
            out += int((g != w).sum())
    return out


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _load_path(path: Path):
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(name: str) -> Path:
    """The reader of metric ``name``: ``metrics/<name>.py``, else the
    reader of the quantity before the name's first dot (``schedule_ms``
    for ``schedule_ms.axelrod``: one quantity split by the end-to-end
    metric its cells report)."""
    path = BENCH / "metrics" / f"{name}.py"
    return path if path.exists() else BENCH / "metrics" / (
        name.split(".")[0] + ".py")


class Cell:
    """A workload of ``BENCHMARK.json`` resolved by name to its
    configuration, traffic, family adapter and metrics. ``overrides``
    ({"config": {...}, "traffic": {...}}) changes sizes for tests."""

    def __init__(self, name: str, overrides: dict | None = None):
        spec = load_spec()
        found = [w for w in spec["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json "
                             f"has {[w['name'] for w in spec['workloads']]}")
        self.workload = found[0]
        self.name = name
        entry = next(c for c in spec["configs"]
                     if c["name"] == self.workload["config"])
        self.config = json.loads((ROOT / entry["file"]).read_text())
        self.traffic = json.loads(
            (BENCH / "traffic" / f"{self.workload['traffic']}.json")
            .read_text())
        overrides = overrides or {}
        self.config.update(overrides.get("config", {}))
        self.traffic.update(overrides.get("traffic", {}))
        self.family = importlib.import_module(
            f"bench.models.{self.config['family']}")
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in spec["per_layer"]
                          if name in m.get("workloads", [name])]

    def read_metrics(self, entries: list[dict], ctx: dict) -> dict:
        out = {}
        for m in entries:
            value = _load_path(reader_path(m["name"])).read(ctx)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out


# ------------------------------------------------------------- stretches
def _span_windows(events: list[dict]) -> list[dict]:
    """ms of each window's fenced schedule, execute and boundary spans."""
    per: dict[int, dict] = {}
    stack = []
    for e in events:
        if e.get("tid") != 0 or e["ph"] not in ("B", "E"):
            continue
        if e["ph"] == "B":
            stack.append(e)
            continue
        b = stack.pop()
        if b["name"] in ("schedule", "execute", "boundary"):
            row = per.setdefault(b["args"]["index"], {})
            row[b["name"]] = (e["ts"] - b["ts"]) / 1e3
    return [per[i] for i in sorted(per)]


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _profile_summary(events, counted: dict) -> dict:
    """Device time by kernel, busy time, idle gaps by host range, and
    the check that the profiler recorded every launch the port's
    counters saw."""
    from torch.autograd import DeviceType

    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    ranges = [e for e in events if e.device_type == DeviceType.CPU
              and e.name.startswith(RANGE_PREFIXES)]
    for sub, want in counted.items():
        got = sum(sub in e.name for e in device)
        if got != want:
            raise IncompleteTrace(
                f"torch.profiler recorded {got} launches of {sub}, the "
                f"port counted {want}: the trace is incomplete")
    by_name: dict[str, float] = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e6
    kernel_s = {sub: sum((e.time_range.end - e.time_range.start) / 1e6
                         for e in device if sub in e.name)
                for sub in counted}
    merged = _union((e.time_range.start, e.time_range.end) for e in device)
    busy = sum(b - a for a, b in merged) / 1e6
    gaps: dict[str, float] = {}
    for (_, end), (start, _) in zip(merged, merged[1:]):
        inside = [r for r in ranges
                  if r.time_range.start <= start <= r.time_range.end]
        label = (min(inside, key=lambda r: r.time_range.end
                     - r.time_range.start).name
                 if inside else "host outside the ranges")
        gaps[label] = gaps.get(label, 0.0) + (start - end) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"kernel_s": kernel_s, "busy_s": busy, "device_ops": top,
            "gaps": gaps}


def _counters(family) -> dict:
    """{"<module>.<counter>": launches so far} from the port's counters."""
    out = {}
    for mod, attrs in family.LAUNCH_COUNTERS.values():
        m = importlib.import_module(f"repro_torch.kernels.{mod}.{mod}")
        for a in attrs:
            out[f"{mod}.{a}"] = getattr(m, a)
    return out


def _per_kernel(family, counters: dict) -> dict:
    """{profiler kernel name: launches} from ``_counters``' keys."""
    return {sub: sum(counters[f"{mod}.{a}"] for a in attrs)
            for sub, (mod, attrs) in family.LAUNCH_COUNTERS.items()}


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def _profiled_call(call, fam, state, dev, attempts: int = 3) -> dict:
    """Calls under ``torch.profiler``: one recording the device alone (its
    busy time, kernel times and wall time are the metrics'), then one
    recording the host's ranges too, which label the idle gaps (the
    host's profiling slows that call). A profile is read only when it
    holds every launch the port's counters saw; the profiler sometimes
    drops a device event, so a call whose profile does not is run again,
    up to ``attempts`` times, and the run fails after that."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    out = {}
    for activities in ([ProfilerActivity.CUDA],
                       [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for attempt in range(attempts):
            before = _counters(fam)
            events = []
            with profile(activities=activities,
                         schedule=schedule(wait=0, warmup=1, active=1),
                         on_trace_ready=lambda p: events.extend(p.events())
                         ) as prof:
                # the measured call is the second step: the profiler can
                # drop the first device events it sees
                torch.ones(1 << 20, device=dev).add_(1).sum().item()
                prof.step()
                t0 = time.perf_counter()
                state, st = call(state)
                window_s = time.perf_counter() - t0
                prof.step()
            launches = {k: v - before[k] for k, v in _counters(fam).items()}
            try:
                summary = _profile_summary(events, _per_kernel(fam, launches))
                break
            except IncompleteTrace:
                if attempt == attempts - 1:
                    raise
            finally:
                del prof, events
        if not out:
            out = dict(summary, window_s=window_s, windows=st["n_windows"],
                       counters=launches, retries=attempt)
        else:
            out["gaps"] = summary["gaps"]
            out["retries"] += attempt
    out["state"] = state
    return out


# ------------------------------------------------------------------ run
def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", overrides: dict | None = None,
             t_start: float | None = None) -> tuple[dict, list[str]]:
    """One run of cell ``name``. Returns the result line's object and
    the check's lines. ``device`` other than "cuda" is for the harness's
    own tests: the profiled and sync-counted stretches then do not run."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.core import ProtocolConfig, run_engine

    marks = {"imports": time.perf_counter()}
    cell = Cell(name, overrides=overrides)
    cfg, tr, fam = cell.config, cell.traffic, cell.family
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        from repro_torch.kernels import _build

        _build.build(fam.KERNELS)
    marks["kernel builds"] = time.perf_counter()
    model = fam.build(cfg, tr, dev)
    pcfg = ProtocolConfig(window=tr["window"], strict=tr["strict"],
                          engine=tr["engine"])
    per_call = tr["tasks_per_call"]
    seeds: list[int] = []

    def call(state):
        s = call_seed(seed, len(seeds))
        seeds.append(s)
        with torch.profiler.record_function("bench.run_engine"):
            out = run_engine(model, state, per_call, seed=s, config=pcfg,
                             device=dev)
        sync()
        return out

    state = fam.initial_state(cfg, tr, seed, dev)
    sync()
    marks["model and state"] = time.perf_counter()
    for _ in range(tr["warmup_calls"]):
        out, _ = run_engine(model, state, per_call,
                            seed=call_seed(seed, -1), config=pcfg,
                            device=dev)
        sync()
        del out
    setup_s = time.perf_counter() - t_start
    marks["warm-up calls"] = t_start + setup_s

    ctx = {"config": cfg, "traffic": tr, "family": fam, "setup_s": setup_s}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    if not trace:
        t0 = time.perf_counter()
        windows = waves = 0
        while True:
            state, st = call(state)
            windows += st["n_windows"]
            waves += st["total_waves"]
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        ctx["window"] = {"seconds": elapsed, "calls": len(seeds),
                         "tasks": len(seeds) * per_call,
                         "windows": windows, "waves": waves}
    else:
        from repro_torch.obs import tracing

        if cuda:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    state, st = call(state)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            ctx["syncs"] = {"count": sum(SYNC_WARNING in str(w.message)
                                         for w in caught),
                            "windows": st["n_windows"]}
        t0 = time.perf_counter()
        spans, windows, waves, traced = [], 0, 0, 0
        while traced < 2 or time.perf_counter() - t0 < seconds:
            with tracing() as tracer:
                state, st = call(state)
            spans += _span_windows(tracer.export()["traceEvents"])
            windows += st["n_windows"]
            waves += st["total_waves"]
            traced += 1
        ctx["spans"] = spans
        ctx["traced"] = {"windows": windows, "waves": waves}
        if cuda:
            ctx["profile"] = _profiled_call(call, fam, state, dev)
            state = ctx["profile"].pop("state")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx["peak_bytes"] = peak

    # ---- the check: the reference runs the same calls from the same
    # initial state, made again from the seed
    ran_program = len(seeds) * per_call
    if cuda:
        torch.cuda.empty_cache()
    ref, ran_ref = fam.reference_run(cfg, tr,
                                     fam.initial_state(cfg, tr, seed, dev),
                                     seeds)
    gap = abs(ran_program - ran_ref)
    check = {"state_mismatch": {"value": state_mismatch(state, ref),
                                "limit": 0},
             "tasks_gap": {"value": gap, "limit": 0}}
    correct = all(c["value"] <= c["limit"] for c in check.values())

    metrics = cell.read_metrics(cell.per_layer if trace else cell.end_to_end,
                                ctx)
    info = {"platform": "gpu" if cuda else device,
            "kind": torch.cuda.get_device_name(dev) if cuda else device,
            "count": 1, "memory_peak_bytes": peak}
    if cuda:
        info["power_limit"] = _power_limit()
    result = {"correct": correct, "attempted": ran_program,
              "failed": 0 if correct else ran_program,
              "metrics": metrics, "device": info}
    if trace and "profile" in ctx:
        p = ctx["profile"]
        info["busy_s"] = p["busy_s"]
        info["window_s"] = p["window_s"]
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in p["device_ops"]],
            "idle_gaps": [[n, s] for n, s in sorted(
                p["gaps"].items(), key=lambda kv: -kv[1])[:10]]}
    result["check"] = check
    t, parts = t_start, []
    for k, v in marks.items():
        parts.append(f"{k} {v - t:.3f} s")
        t = v
    lines = ["set-up: " + ", ".join(parts)]
    if "profile" in ctx:
        lines.append(f"profiled calls run again: {ctx['profile']['retries']}")
    lines += [f"check {k}: {v['value']} (limit {v['limit']})"
             for k, v in check.items()]
    return result, lines

"""The port's observability layer against the JAX package's, on the CPU.

The stats registry equals the reference's (keys, kinds, groups,
descriptions, version, row schema) and ``finalize_stats`` normalizes and
rejects what the reference's does; the span tracer is off by default,
subdivides and exports as the reference's does, and its validator
rejects the reference's malformed payloads; a traced run of each engine
is bit-exact with the untraced one and records the reference's events
(name, phase, category, thread and args — not the timestamps) on the
reference's threads (tids 0-2) for the same model, seed and window — for
the sharded engines at world size 1 also the execute spans' rung, the
waves' per-rank ``owned`` counts and the comm thread's ``halo_gather``
spans (rung, rows, bytes), one per collective the run issued; the port's
own layers thread (tid 3) holds one span per ``annotate`` range, each
inside its window's span, and the process-wide totals the benchmark
reads; with tracing off the engines reach none of the trace hooks, and
``annotate`` neither a profiler range nor the tracer; the tracer and
``torch.profiler`` share one clock; ``block_all``, ``median_time``, the
profiler session and ``provenance`` work on the CPU."""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax  # noqa: E402

from repro import mabs as JM  # noqa: E402
from repro import obs as JO  # noqa: E402
from repro import topology as JT  # noqa: E402
from repro.engine import make_engine as j_make_engine  # noqa: E402
from repro.obs import stats as JS  # noqa: E402
from repro_torch import mabs as PM  # noqa: E402
from repro_torch import obs as PO  # noqa: E402
from repro_torch import topology as PT  # noqa: E402
from repro_torch.bridge import state_from_numpy  # noqa: E402
from repro_torch.engine import base as engine_base  # noqa: E402
from repro_torch.engine import make_engine  # noqa: E402
from repro_torch.engine import sequential as engine_sequential  # noqa: E402
from repro_torch.engine import sharded as engine_sharded  # noqa: E402
from repro_torch.engine import wavefront as engine_wavefront  # noqa: E402
from repro_torch.obs import stats as PS  # noqa: E402
from repro_torch.obs import trace as ptrace  # noqa: E402
from repro_torch.obs.profiler import annotate, profile_session  # noqa: E402
from repro_torch.utils import timing  # noqa: E402

CPU = "cpu"
ENGINES = ["sequential", "wavefront", "wavefront_overlap", "sharded",
           "sharded_overlap"]


# ------------------------------------------------------------ stats registry
def _spec(s):
    return (s.key, s.kind, s.group, s.description, s.nullable)


def test_registry_equals_reference():
    assert PS.STATS_VERSION == JS.STATS_VERSION
    assert PS.GROUPS == JS.GROUPS
    assert ([_spec(s) for s in PO.registry().values()]
            == [_spec(s) for s in JO.registry().values()])
    for group in JS.GROUPS:
        assert PO.row_keys(group) == JO.row_keys(group)
    assert PO.row_keys() == JO.row_keys() == tuple(PO.registry())
    assert PO.row_keys("comm", "overlap") == JO.row_keys("comm", "overlap")
    with pytest.raises(ValueError, match="group"):
        PO.row_keys("no_such_group")


NORMALIZED = [
    {"total_tasks": np.int64(7), "mean_parallelism": np.float32(1.5),
     "halo": np.bool_(True), "comm_modes": {"split": np.int32(3)},
     "per_wave_split_rows": None},
    {"total_waves": 3.0, "overlap": 0, "carry_frontier_mean": 2},
    {"n_windows": True, "max_overlap_depth": np.uint8(4)},
]


@pytest.mark.parametrize("stats", NORMALIZED, ids=range(len(NORMALIZED)))
def test_finalize_stats_normalizes_as_reference(stats):
    want = JO.finalize_stats(stats)
    got = PO.finalize_stats(stats)
    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]
    # 0-d tensors, the port's own accumulators, normalize the same way
    as_tensors = {k: (torch.as_tensor(np.asarray(v))
                      if isinstance(v, (np.generic, int, float)) else v)
                  for k, v in stats.items()}
    assert PO.finalize_stats(as_tensors) == want


REJECTED = [
    ({"no_such_stat": 1}, "undeclared"),
    ({"total_tasks": None}, "not nullable"),
    ({"mean_parallelism": float("nan")}, "non-finite"),
    ({"total_waves": math.inf}, "non-finite"),
    ({"comm_modes": [1, 2]}, "mapping"),
]


@pytest.mark.parametrize("stats,match", REJECTED,
                         ids=[m for _, m in REJECTED])
def test_finalize_stats_rejects_as_reference(stats, match):
    with pytest.raises(ValueError, match=match):
        JO.finalize_stats(stats)
    with pytest.raises(ValueError, match=match):
        PO.finalize_stats(stats)


def test_finalize_stats_non_strict_passes_unknown_keys():
    stats = {"no_such_stat": [1], "total_tasks": np.int64(2)}
    assert (PO.finalize_stats(stats, strict=False)
            == JO.finalize_stats(stats, strict=False)
            == {"no_such_stat": [1], "total_tasks": 2})


# ---------------------------------------------------------------- tracer
def test_tracing_off_by_default():
    assert PO.current_tracer() is None
    with PO.tracing() as tr:
        assert PO.current_tracer() is tr
        with PO.tracing() as inner:     # blocks nest, inner wins
            assert PO.current_tracer() is inner
        assert PO.current_tracer() is tr
    assert PO.current_tracer() is None


def test_span_tracer_subdivide_and_export(tmp_path):
    tr = PO.SpanTracer()
    with tr.span("run", engine="test") as run:
        with tr.span("execute", index=0) as sp:
            pass
        sp.args["n_waves"] = 2          # args mutable after exit
        slots = tr.subdivide(sp, "wave", [3, 1],
                             [{"level": 0}, {"level": 1}])
    assert run.t1 is not None and len(tr) == 6
    assert slots[0][0] == pytest.approx(sp.t0)
    assert slots[0][1] == pytest.approx(3 * slots[1][1])
    assert slots[1][0] + slots[1][1] == pytest.approx(sp.t1)
    payload = tr.export(str(tmp_path / "t.json"))
    assert PO.validate_chrome_trace(payload) == len(payload["traceEvents"])
    on_disk = json.loads((tmp_path / "t.json").read_text())
    assert JO.validate_chrome_trace(on_disk) == len(on_disk["traceEvents"])
    waves = [e for e in on_disk["traceEvents"] if e["name"] == "wave"]
    assert [w["args"]["level"] for w in waves] == [0, 1]
    assert all(w["args"]["attributed"] for w in waves)
    meta = [e for e in on_disk["traceEvents"] if e["ph"] == "M"]
    assert ([e for e in meta if e["tid"] != ptrace.TID_LAYERS]
            == [e for e in JO.SpanTracer().events() if e["ph"] == "M"])
    assert [e["args"]["name"] for e in meta
            if e["tid"] == ptrace.TID_LAYERS] == ["layers"]
    with pytest.raises(ValueError, match="closed span"):
        with tr.span("open") as sp_open:
            tr.subdivide(sp_open, "wave", [1], [{}])


_OK = {"name": "a", "ph": "B", "ts": 1.0, "pid": 1, "tid": 0}
_END = {"name": "a", "ph": "E", "ts": 2.0, "pid": 1, "tid": 0}
MALFORMED = [
    ({}, "traceEvents"),
    ("nope", "not a trace payload"),
    ([1], "not an object"),
    ([{"ph": "B", "ts": 0, "pid": 1, "tid": 0}], "missing"),
    ([dict(_OK, ph="Q")], "unknown.*phase"),
    ([dict(_OK, ts=-1.0)], "bad ts"),
    ([dict(_OK, ph="X")], "bad.*dur"),
    ([_OK], "unclosed"),
    ([_END], "without open B"),
    ([_OK, {"name": "b", "ph": "B", "ts": 1.5, "pid": 1, "tid": 0}, _END,
      {"name": "b", "ph": "E", "ts": 2.5, "pid": 1, "tid": 0}],
     "cross-nested"),
]


@pytest.mark.parametrize("payload,match", MALFORMED,
                         ids=[m for _, m in MALFORMED])
def test_validator_rejects_reference_malformed(payload, match):
    with pytest.raises(ValueError, match=match):
        JO.validate_chrome_trace(payload)
    with pytest.raises(ValueError, match=match):
        PO.validate_chrome_trace(payload)


def test_validator_accepts_matched_spans():
    assert PO.validate_chrome_trace([_OK, _END]) == 2
    assert PO.validate_chrome_trace({"traceEvents": [_OK, _END]}) == 2


# -------------------------------------------------------- traced engines
def _models(name):
    if name == "voter":
        return (JM.VoterModel(JT.ring(48, 4)),
                PM.VoterModel(PT.ring(48, 4, device=CPU)))
    cfg = dict(n_agents=120, k=6, subset_size=10, i0=0.3)
    return (JM.SIRModel(JM.SIRConfig(**cfg)),
            PM.SIRModel(PM.SIRConfig(**cfg), device=CPU))


def _by_thread(events):
    """Events per reference thread (tids 0-2) in export order, without
    their timestamps; the port's layers thread is checked on its own."""
    out = {}
    for e in events:
        if e["tid"] != ptrace.TID_LAYERS:
            out.setdefault(e["tid"], []).append(
                {k: e.get(k) for k in ("name", "ph", "cat", "pid", "args")})
    return out


def _window_spans(events):
    """{(name, index): (ts, end)} of the B/E spans on the windows thread."""
    out, stack = {}, []
    for e in events:
        if e["tid"] != 0 or e["ph"] not in ("B", "E"):
            continue
        if e["ph"] == "B":
            stack.append(e)
        else:
            b = stack.pop()
            out[(b["name"], b["args"].get("index"))] = (b["ts"], e["ts"])
    return out


def _check_layers(events):
    """Every layer span (tid 3) is an X event inside the span of the
    window its ``window`` arg names; returns them."""
    layers = [e for e in events
              if e["tid"] == ptrace.TID_LAYERS and e["ph"] != "M"]
    spans = _window_spans(events)
    for e in layers:
        assert e["ph"] == "X" and e["name"].startswith("protocol.")
        w = e["args"]["window"]
        if w is None:
            continue
        inside = [(a, b) for (n, i), (a, b) in spans.items()
                  if i == w and a <= e["ts"] and e["ts"] + e["dur"] <= b]
        assert inside, f"{e['name']} outside every span of window {w}"
    return layers


@pytest.mark.parametrize("ename", ENGINES)
@pytest.mark.parametrize("model", ["voter", "sirs"])
def test_traced_run_matches_reference(model, ename):
    jm, pm = _models(model)
    js0 = jm.init_state(jax.random.key(1))
    ps0 = state_from_numpy({k: np.asarray(v) for k, v in js0.items()}, CPU)
    j_eng = j_make_engine(ename, jm, window=16)
    p_eng = make_engine(ename, pm, window=16, device=CPU)
    with JO.tracing() as jtr:
        j_out, j_stats = j_eng.run(js0, 40, seed=2)
    plain_out, plain_stats = p_eng.run(ps0, 40, seed=2)
    with PO.tracing() as ptr:
        p_out, p_stats = p_eng.run(ps0, 40, seed=2)
    for k, v in plain_out.items():
        assert torch.equal(p_out[k], v), f"{ename} diverged under tracing"
        np.testing.assert_array_equal(v.numpy(), np.asarray(j_out[k]))
    assert p_stats == plain_stats == j_stats
    payload = ptr.export()
    PO.validate_chrome_trace(payload)
    assert _by_thread(payload["traceEvents"]) == _by_thread(jtr.events())
    layers = _check_layers(payload["traceEvents"])
    assert layers
    names = {e["name"] for e in payload["traceEvents"]}
    assert {"run", "execute"} <= names
    if ename != "sequential":
        waves = [e for e in ptr.events() if e["name"] == "wave"]
        assert len(waves) == p_stats["total_waves"]
        assert sum(e["args"]["width"] for e in waves) == 40
    if ename.endswith("_overlap"):
        assert "boundary" in names
    if ename.startswith("sharded"):
        # one halo_gather span per collective: none for an empty wave
        gathers = [e for e in ptr.events() if e["name"] == "halo_gather"]
        assert gathers and len(gathers) == p_eng.agents.collectives
        assert all(e["args"]["rung"] == "split" for e in gathers)
        assert (sum(e["args"]["bytes"] for e in gathers)
                == p_stats["comm_bytes_total"])
    # a run outside tracing() records nothing into the old tracer
    n = len(ptr)
    p_eng.run(ps0, 40, seed=2)
    assert len(ptr) == n


@pytest.mark.parametrize("ename", ENGINES)
def test_untraced_run_reaches_no_trace_hook(ename, monkeypatch):
    """With no tracer installed the loops build no span and reach no
    hook: no trace bookkeeping, no fence."""
    def refuse(*args, **kwargs):
        raise AssertionError("a trace hook ran with tracing off")

    for name in ("_trace_parts", "_trace_window", "_traced_execute"):
        monkeypatch.setattr(engine_base.WindowedEngine, name, refuse)
    monkeypatch.setattr(engine_wavefront.WavefrontEngine, "_trace_parts",
                        refuse)
    for name in ("_trace_parts", "_trace_wave_comm", "_trace_execute_args"):
        monkeypatch.setattr(engine_sharded.ShardedEngine, name, refuse)
    monkeypatch.setattr(engine_base, "block_all", refuse)
    monkeypatch.setattr(engine_sequential, "block_all", refuse)
    for name in ("span", "open_layer", "close_layer"):
        monkeypatch.setattr(PO.SpanTracer, name, refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _, pm = _models("voter")
    ps0 = pm.init_state(torch.tensor([0, 1]), device=CPU)
    assert PO.current_tracer() is None
    _, stats = make_engine(ename, pm, window=16, device=CPU).run(ps0, 40)
    assert stats["total_tasks"] == 40


# ------------------------------------------------------------ layer spans
def _axelrod():
    return PM.AxelrodModel(PM.AxelrodConfig(n_agents=200, n_features=5),
                           device=CPU)


def _port_model(name):
    return _axelrod() if name == "axelrod" else _models(name)[1]


def _count_calls(monkeypatch, cls, attr):
    """Wrap ``cls.attr`` to count its calls."""
    calls = []
    orig = getattr(cls, attr)

    def counted(self, *args, **kwargs):
        calls.append(1)
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(cls, attr, counted)
    return calls


#: scatter_rows calls per execute_wave: SIRS computes and commits
SCATTERS = {"voter": 1, "sirs": 2, "axelrod": 1}


@pytest.mark.parametrize("ename", ["wavefront", "wavefront_overlap"])
@pytest.mark.parametrize("model", ["voter", "sirs", "axelrod"])
def test_traced_run_records_layer_spans(model, ename, monkeypatch):
    """One create_tasks span a window, one draws span per execute_wave
    of a model that draws, as many scatter_rows spans as the waves make
    calls, each inside the span of the window its ``window`` names; the
    process-wide totals add what the block recorded."""
    pm = _port_model(model)
    s0 = pm.init_state(torch.tensor([0, 3]), device=CPU)
    waves = _count_calls(monkeypatch, type(pm), "execute_wave")
    ptrace.reset_layer_totals()
    with PO.tracing() as tr:
        _, stats = make_engine(ename, pm, window=16, device=CPU).run(
            s0, 40, seed=4)
    events = tr.export()["traceEvents"]
    PO.validate_chrome_trace(events)
    layers = _check_layers(events)
    n = {}
    for e in layers:
        n[e["name"]] = n.get(e["name"], 0) + 1
    windows = stats["n_windows"]
    assert n["protocol.create_tasks"] == windows
    assert n.get("protocol.draws", 0) == (0 if model == "voter"
                                          else len(waves))
    assert n["protocol.scatter_rows"] == SCATTERS[model] * len(waves)
    assert n["protocol.wave"] == stats["total_waves"]
    named = [e for e in layers if e["name"] in (
        "protocol.create_tasks", "protocol.draws", "protocol.scatter_rows",
        "protocol.wave", "protocol.wave_kernel")]
    assert all(e["args"]["window"] is not None for e in named)
    assert all("wave" in e["args"] for e in named
               if e["name"] != "protocol.create_tasks")
    creations = sorted(e["args"]["window"] for e in layers
                       if e["name"] == "protocol.create_tasks")
    assert creations == list(range(windows))
    totals = ptrace.layer_totals()
    assert totals["windows"] == windows
    assert {k: v["count"] for k, v in totals["spans"].items()} == n
    for v in totals["spans"].values():     # on the CPU device = host
        assert v["device_ms"] == v["host_ms"] >= 0.0


def test_layer_totals_sum_blocks_until_reset():
    pm = _port_model("sirs")
    s0 = pm.init_state(torch.tensor([0, 3]), device=CPU)
    eng = make_engine("wavefront", pm, window=16, device=CPU)
    ptrace.reset_layer_totals()
    assert ptrace.layer_totals() == {"windows": 0, "spans": {}}
    tr = PO.SpanTracer()
    for _ in range(2):                     # one tracer, two blocks
        with PO.tracing(tr):
            eng.run(s0, 40, seed=4)
    eng.run(s0, 40, seed=4)                # untraced: adds nothing
    totals = ptrace.layer_totals()
    assert totals["windows"] == 6
    mine = tr.totals()
    assert totals["spans"].keys() == mine["spans"].keys()
    for k, v in totals["spans"].items():   # summed in another order
        assert v == pytest.approx(mine["spans"][k])
    assert totals["spans"]["protocol.create_tasks"]["count"] == 6
    ptrace.reset_layer_totals()
    assert ptrace.layer_totals() == {"windows": 0, "spans": {}}


def test_annotate_off_reaches_neither_profiler_nor_tracer(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("annotate reached a hook with both off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for name in ("span", "open_layer", "close_layer"):
        monkeypatch.setattr(PO.SpanTracer, name, refuse)
    assert PO.current_tracer() is None
    with annotate("protocol.test") as a, annotate("protocol.wave", wave=3):
        assert a is None
    assert annotate("protocol.a") is annotate("protocol.b")


#: the ranges a run of SIRS through wavefront_overlap opens
RANGES = ("protocol.schedule", "protocol.create_tasks", "protocol.conflict",
          "protocol.conflict_block", "protocol.carry_frontier",
          "protocol.levels", "protocol.boundary", "protocol.execute_pair",
          "protocol.execute_window", "protocol.wave", "protocol.draws",
          "protocol.wave_kernel", "protocol.scatter_rows")


def test_profile_holds_every_protocol_range():
    from torch.profiler import ProfilerActivity, profile

    pm = _port_model("sirs")
    s0 = pm.init_state(torch.tensor([0, 3]), device=CPU)
    eng = make_engine("wavefront_overlap", pm, window=16, device=CPU)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run(s0, 40, seed=4)
    names = {e.name for e in prof.events()}
    assert set(RANGES) <= names
    assert not {"protocol.run", "protocol.execute"} & names  # untraced


def test_tracer_and_profiler_share_one_clock():
    """Under a tracer and a profiler at once, each window span of tid 0
    opens the range ``protocol.<name>``, and the two agree at both ends
    within 1 ms on the profiler's clock; layer spans match their ranges
    the same way."""
    from torch.profiler import ProfilerActivity, profile

    pm = _port_model("axelrod")
    s0 = pm.init_state(torch.tensor([0, 3]), device=CPU)
    eng = make_engine("wavefront_overlap", pm, window=16, device=CPU)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with PO.tracing() as tr:
            eng.run(s0, 40, seed=4)
    base = prof.profiler.kineto_results.trace_start_ns()
    events = tr.export(base_ns=base)["traceEvents"]
    ranges: dict[str, list] = {}
    for e in prof.events():
        if e.name.startswith("protocol."):
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    spans = sorted(_window_spans(events).items(), key=lambda kv: kv[1])
    names = set()
    for (name, _), (t0, t1) in spans:
        if name == "run":
            continue
        names.add(name)
        got = ranges[f"protocol.{name}"]
        assert min(abs(a - t0) + abs(b - t1) for a, b in got) < 1e3, name
    assert names == {"schedule", "execute", "boundary"}
    for (lo, hi) in [(e["ts"], e["ts"] + e["dur"]) for e in events
                     if e["tid"] == ptrace.TID_LAYERS and e["ph"] == "X"]:
        assert lo >= 0 and hi >= lo
    layer = [e for e in events if e["name"] == "protocol.create_tasks"]
    for e in layer:
        assert min(abs(a - e["ts"]) + abs(b - e["ts"] - e["dur"])
                   for a, b in ranges["protocol.create_tasks"]) < 1e3
    other = tr.export()
    assert other["otherData"]["epoch_ns"] == tr.epoch_ns
    assert tr.export(base_ns=base)["otherData"]["epoch_ns"] == base
    shift = (tr.epoch_ns - base) / 1e3
    first = next(e for e in other["traceEvents"] if "ts" in e)
    assert any(e.get("ts") == pytest.approx(first["ts"] + shift)
               for e in events)


# ------------------------------------------- timing, profiler, provenance
def test_block_all_passes_through(monkeypatch):
    """CPU (and meta) leaves need no fence: no synchronize is called, and
    the pytree comes back as it was."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    out = {"a": torch.ones(4), "b": (torch.zeros(2, 2), 3, None),
           "c": [torch.empty(2, device="meta")]}
    assert timing.block_all(out) is out
    assert calls == []
    t = timing.median_time(lambda: {"x": torch.arange(8) * 2, "n": 1},
                           repeats=3, warmup=1)
    assert t >= 0.0 and len(t.samples) == 3 and t.min_s <= float(t)
    assert t.rel_spread >= 0.0
    with timing.Timer() as tm:
        pass
    assert tm.elapsed >= 0.0


def test_profile_session_labels_protocol_phases(tmp_path):
    with profile_session(None) as prof:
        assert prof is None
    _, pm = _models("voter")
    ps0 = pm.init_state(torch.tensor([0, 1]), device=CPU)
    eng = make_engine("wavefront", pm, window=16, device=CPU)
    with profile_session(str(tmp_path / "prof")) as prof:
        assert prof is not None
        eng.run(ps0, 40)
    text = (tmp_path / "prof" / "trace.json").read_text()
    for name in ("protocol.execute_window", "protocol.wave"):
        assert name in text
    with annotate("protocol.test"):   # no profiler: a no-op
        pass


def test_provenance_is_json_safe():
    p = PO.provenance()
    assert set(p) >= {"torch_version", "cuda_version", "backend",
                      "device_kind", "device_count", "timestamp", "git_sha",
                      "stats_version", "hostname"}
    assert p["torch_version"] == str(torch.__version__)
    assert p["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert isinstance(p["device_count"], int) and p["device_count"] >= 1
    assert isinstance(p["device_kind"], str) and p["device_kind"]
    assert "T" in p["timestamp"]
    assert p["stats_version"] == PO.STATS_VERSION
    assert p["git_sha"] is None or isinstance(p["git_sha"], str)
    assert json.loads(json.dumps(p)) == p

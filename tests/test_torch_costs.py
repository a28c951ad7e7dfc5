"""The port's cost telemetry (``repro_torch.obs.costs``,
``repro_torch.launch.hlo_analysis``) against the JAX package's, on the CPU.

  (a) a trace built through the recorder with the loop structure of
      tests/test_costs.py's synthetic HLO module (a data-dependent wave
      loop with an f32[16] all-gather in a group of 8, a nested chunk
      loop with an f32[8] collective-permute, a static loop of 5 with an
      f32[4] all-reduce in groups of 4) parses to the reference's numbers
      on that text, computed live;
  (b) ``executor_cost`` of one executed call against the reference's
      ``executor_cost`` of the jitted twin: a matmul exactly, an
      elementwise chain and its sum in FLOPs and buffers (XLA fuses the
      chain, so the port's bytes accessed are at least the reference's);
      the arguments untouched; an indexing op's bytes by the elements it
      touches (where XLA counts the whole operand); a replayed loop;
  (c) ``ledger_cross_check``'s exact and mismatch cases, and the raise of
      ``parse_collectives`` on a call site whose unit bytes change;
  (d) recording off: the engines read the host no more than before and
      never reach the recorder; ``compiled_costs`` at world size 1 holds
      the cross-check identity on every rung, leaves the caller's state
      as it was, and counts the wave kernels' launches and work (the
      kernels' CUDA branches taken with their plain versions standing in
      for the kernels, as the card would take them).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.obs import costs as J  # noqa: E402
from repro.launch import hlo_analysis as JH  # noqa: E402
from repro_torch import mabs as PM  # noqa: E402
from repro_torch import topology as PT  # noqa: E402
from repro_torch.engine import make_engine  # noqa: E402
from repro_torch.launch import hlo_analysis as PH  # noqa: E402
from repro_torch.obs import costs as P  # noqa: E402
from repro_torch.utils import prng  # noqa: E402
from test_costs import SYNTH_HLO  # noqa: E402

CPU = "cpu"
ITERS = {0: 1, 1: 7, 2: 3}


def synthetic_trace(wave_trips=7, chunk_trips=3):
    """The synthetic module's loops, executed: ``wave_trips`` waves, each
    with its all-gather and ``chunk_trips`` chunks of a collective-permute,
    then the static loop of 5 all-reduces."""
    with P.recording() as rec:
        with rec.loop():
            for _ in range(wave_trips):
                rec.collective("all-gather", 64, 8, type_str="f32[16]")
                with rec.loop():
                    for _ in range(chunk_trips):
                        rec.collective("collective-permute", 32, None,
                                       type_str="f32[8]")
        with rec.loop(5):
            for _ in range(5):
                rec.collective("all-reduce", 16, 4, type_str="f32[4]")
    return rec.trace


# ------------------------------------------------------------------- (a)
def test_trace_parses_to_the_reference_numbers():
    want = J.parse_collectives(SYNTH_HLO)
    got = P.parse_collectives(synthetic_trace())
    assert got.bytes_by_depth() == want.bytes_by_depth()
    assert got.total_bytes(ITERS) == want.total_bytes(ITERS)
    assert got.wire_bytes(ITERS) == want.wire_bytes(ITERS)
    key = lambda o: (o.op, o.depth)  # noqa: E731
    for g, w in zip(sorted(got.ops, key=key), sorted(want.ops, key=key)):
        assert (g.op, PH._shape_bytes(g.type_str), g.bytes_per_call,
                g.static_mult, g.depth, g.group_size) == (
                    w.op, JH._shape_bytes(w.type_str), w.bytes_per_call,
                    w.static_mult, w.depth, w.group_size)


def test_one_trip_trace_analyzes_to_the_reference_stats():
    """``analyze_collectives`` counts what executed; with each
    data-dependent loop run once (the reference counts an unknown trip
    count as 1) its stats equal the reference's on the HLO text — but
    for the async all-gather, whose ``-start`` and ``-done`` halves the
    reference's text walk counts as two (its ``parse_collectives`` skips
    the ``-done``; the port issued one), and whose group it reads as 2
    for want of the iota form ``[n,m]`` (the port's group is the 8 the
    line lists): its wire bytes are compared by ``parse_collectives``
    above."""
    want = JH.analyze_collectives(SYNTH_HLO)
    got = PH.analyze_collectives(synthetic_trace(1, 1))
    for field in ("raw_bytes", "loop_bytes", "wire_bytes", "count"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.keys() == w.keys()
        for op in g:
            if op == "all-gather":
                if field != "wire_bytes":
                    assert 2 * g[op] == w[op], field
            else:
                assert g[op] == w[op], (field, op)
    assert got.unknown_trip_whiles == want.unknown_trip_whiles == 2
    many = PH.analyze_collectives(synthetic_trace())
    assert many.loop_bytes == {"all-gather": 7 * 64,
                               "collective-permute": 21 * 32,
                               "all-reduce": 5 * 16}
    assert many.raw_bytes["all-reduce"] == 16   # one body of the scan
    assert many.unknown_trip_whiles == 2


def test_wire_table_is_the_references():
    for op, f in JH._WIRE_FACTOR.items():
        for n in (1, 2, 4, 8, 256):
            assert PH._WIRE_FACTOR[op](n) == f(n)
    assert PH._DTYPE_BYTES == JH._DTYPE_BYTES
    for t in ("f32[16]", "(f32[4], s32[])", "u8[64,4]", "bf16[2,3,4]"):
        assert PH._shape_bytes(t) == JH._shape_bytes(t)
    from repro_torch.distributed import collectives

    assert collectives._WIRE_FACTOR is PH._WIRE_FACTOR


# ------------------------------------------------------------------- (b)
def test_matmul_costs_equal_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 32)).astype(np.float32)
    w = rng.standard_normal((32, 16)).astype(np.float32)
    want = J.executor_cost(jax.jit(lambda a, b: a @ b), jnp.asarray(x),
                           jnp.asarray(w), name="mm")
    px, pw = torch.from_numpy(x.copy()), torch.from_numpy(w.copy())
    got = P.executor_cost(lambda a, b: a @ b, px, pw, name="mm")
    assert (got.flops, got.bytes_accessed, got.argument_bytes,
            got.output_bytes) == (want.flops, want.bytes_accessed,
                                  want.argument_bytes, want.output_bytes)
    assert got.flops == 65_536 and got.bytes_accessed == 14_336
    assert (got.argument_bytes, got.output_bytes) == (10_240, 4_096)
    assert torch.equal(px, torch.from_numpy(x))
    assert torch.equal(pw, torch.from_numpy(w))


def test_elementwise_costs_equal_the_reference():
    want = J.executor_cost(jax.jit(lambda a: (a * 2.0 + 1.0).sum()),
                           jnp.ones((64,), jnp.float32), name="toy")
    x = torch.ones(64)
    got = P.executor_cost(lambda a: (a * 2.0 + 1.0).sum(), x, name="toy")
    assert got.flops == want.flops == 191
    assert got.argument_bytes == want.argument_bytes == 256
    assert got.output_bytes == want.output_bytes == 4
    assert got.bytes_accessed >= want.bytes_accessed
    assert got.peak_bytes >= got.output_bytes
    assert not got.collectives.ops
    row = got.as_row({1: 3})
    json.dumps(row)
    assert set(row) == set(want.as_row({1: 3}))
    assert row["collective_bytes"] == 0
    assert torch.equal(x, torch.ones(64))


def test_executor_cost_runs_on_clones_of_in_place_arguments():
    x = torch.arange(8.0)
    got = P.executor_cost(lambda a: a.mul_(3), x)
    assert torch.equal(x, torch.arange(8.0))
    assert got.flops == 8 and got.output_bytes == 32
    assert got.temp_bytes == 0   # the output is the argument's storage


def _rows(n):
    x = torch.ones(n, 8)
    idx = torch.tensor([1, 5, 7])
    return x, idx, idx[:, None].expand(3, 8), torch.ones(3, 8)


#: an indexing op and its bytes: the indices and values it reads and the
#: elements of ``x`` it touches (idx 24 B, idx expanded 192 B, v and a
#: gathered [3, 8] 96 B each)
INDEXING = {
    "index": (lambda x, i, i2, v: x[i], 24 + 2 * 96),
    "index_select": (lambda x, i, i2, v: x.index_select(0, i), 24 + 2 * 96),
    "gather": (lambda x, i, i2, v: torch.gather(x, 0, i2), 192 + 2 * 96),
    "embedding": (lambda x, i, i2, v: torch.nn.functional.embedding(i, x),
                  24 + 2 * 96),
    "index_put_": (lambda x, i, i2, v: x.index_put_((i,), v), 24 + 2 * 96),
    "scatter_": (lambda x, i, i2, v: x.scatter_(0, i2, v), 192 + 2 * 96),
    "index_add_": (lambda x, i, i2, v: x.index_add_(0, i, v), 24 + 3 * 96),
    "new_zeros": (lambda x, i, i2, v: x.new_zeros(3, 8), 96),
}


@pytest.mark.parametrize("op", sorted(INDEXING))
def test_indexing_counts_the_elements_it_touches(op):
    """A gather or an in-place scatter counts its indices, its values and
    the elements of its operand it touches, whatever the operand's size
    (a factory its result alone). The reference's XLA cost model counts
    the whole operand of a gather (3.2 MB for [10^5, 8] float32), which
    a roofline cannot use; the port departs from it here."""
    fn, want = INDEXING[op]
    for n in (1_000, 100_000):
        got = P.record_call(fn, *_rows(n))
        assert got.bytes_accessed == want, (n, got.bytes_accessed)
    if op == "index":
        ref = J.executor_cost(jax.jit(lambda x, i: x[i]),
                              jnp.ones((100_000, 8), jnp.float32),
                              jnp.asarray([1, 5, 7], jnp.int32))
        assert ref.bytes_accessed > 3_200_000 > 100 * want


def test_a_replayed_loop_stands_for_its_trips():
    """``loop(trips, run)``: the iterations that run stand for all; a
    count of runs that does not divide the trips raises."""
    with P.recording() as rec:
        with rec.loop(4, run=1):
            rec.collective("all-reduce", 16, 4)
            rec.kernel("k", 10, 3)
    (e,) = rec.trace.events
    assert (e.repeat, e.static_mult) == (4, 4)
    assert rec.kernels["k"] == {"launches": 4, "bytes": 40, "ops": 12}
    stats = PH.analyze_collectives(rec.trace)
    assert stats.loop_bytes == {"all-reduce": 64}
    assert stats.raw_bytes == {"all-reduce": 16}
    with pytest.raises(ValueError, match="cannot stand"):
        with rec.loop(4, run=3):
            pass


def test_replayed_train_step_runs_on_the_meta_device_only():
    """The dry run's replayed step (one microbatch standing for all)
    refuses real tensors, whose gradients it would get wrong, and runs
    only under a recorder."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import replayed_train_step
    from repro_torch.models import build_model
    from repro_torch.train.step import init_train_state

    model = build_model(get_config("smollm-360m").reduced(), CPU)
    state = init_train_state(model, 0, device=CPU)
    batch = {"tokens": torch.zeros(4, 8, dtype=torch.int32),
             "labels": torch.zeros(4, 8, dtype=torch.int32)}
    step = replayed_train_step(model, 2)
    with P.recording(), pytest.raises(ValueError, match="meta device"):
        step(state, batch)


# ------------------------------------------------------------------- (c)
def _one_op_cost(pkg):
    coll = pkg.HloCollectives(ops=[pkg.CollectiveOp(
        op="all-gather", type_str="f32[16]", bytes_per_call=64,
        static_mult=1, depth=1, group_size=8)])
    return pkg.ExecutorCost(name="x", flops=0, bytes_accessed=0,
                            argument_bytes=0, output_bytes=0, temp_bytes=0,
                            collectives=coll)


@pytest.mark.parametrize("ledger", [64 * 7, 64 * 7 + 1, 0])
def test_ledger_cross_check_equals_the_reference(ledger):
    for costs in ({"x": None}, [None]):
        args = ({1: 7}, ledger)
        j = J.ledger_cross_check(
            {"x": _one_op_cost(J)} if isinstance(costs, dict)
            else [_one_op_cost(J)], *args)
        p = P.ledger_cross_check(
            {"x": _one_op_cost(P)} if isinstance(costs, dict)
            else [_one_op_cost(P)], *args)
        assert (p.parsed_bytes, p.ledger_bytes, p.ratio, p.ok) == (
            j.parsed_bytes, j.ledger_bytes, j.ratio, j.ok)
    assert p.ok == (ledger == 448)


def test_parse_raises_on_a_site_whose_unit_bytes_change():
    with P.recording() as rec:
        with rec.loop():
            for nbytes in (64, 64, 96):
                rec.collective("all-reduce", nbytes, 4)
    with pytest.raises(ValueError, match="one call site"):
        P.parse_collectives(rec.trace)
    # the same bytes in more units is one site, whatever the units
    with P.recording() as rec:
        with rec.loop():
            for units in (1, 3, 2):
                rec.collective("all-reduce", 64, 4, units)
    (op,) = P.parse_collectives(rec.trace).ops
    assert op.bytes_per_call == 64 and op.depth == 1
    with pytest.raises(ValueError, match="wire model"):
        rec.collective("broadcast", 4, 2)


def test_recorder_restores_and_nests():
    assert P.current_recorder() is None
    with P.recording() as outer:
        with P.recording() as inner:
            assert P.current_recorder() is inner
        assert P.current_recorder() is outer
    assert P.current_recorder() is None


# ------------------------------------------------------------------- (d)
def _sis():
    topo = PT.watts_strogatz(256, 4, 0.1, prng.key(0, device=CPU),
                             device=CPU)
    return PM.SISModel(topo)


def test_recording_off_adds_no_host_read(monkeypatch):
    """tests/test_torch_sharded.py's read counter, with the recorder's
    entry points patched to raise: untraced, unrecorded windows of the
    wavefront and sharded engines read the host once a window (the wave
    count, with the split rung's chunk offsets in the same copy) and
    never reach the recorder."""
    def boom(*args, **kwargs):
        raise AssertionError("the recorder was reached with none installed")

    for name in ("loop", "collective", "kernel"):
        monkeypatch.setattr(P.CostRecorder, name, boom)
    reads = [0]
    for name in ("item", "tolist", "cpu", "numpy", "__int__", "__float__",
                 "__bool__", "__index__"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *args, _orig=orig, **kwargs):
            reads[0] += 1
            return _orig(self, *args, **kwargs)
        monkeypatch.setattr(torch.Tensor, name, counted)
    model = _sis()
    st0 = model.init_state(prng.key(7, device=CPU), device=CPU)
    for ename in ("wavefront", "sharded", "sharded_window_halo",
                  "sharded_replicated"):
        eng = make_engine(ename, model, window=64, device=CPU)
        reads[0] = 0
        _, stats = eng.run(st0, 640, seed=3)
        assert reads[0] == stats["n_windows"] == 10, ename


@pytest.mark.parametrize("ename", ["sharded", "sharded_window_halo",
                                   "sharded_replicated"])
def test_world_one_cross_check_is_exact(ename):
    """The reference's cross-check (tests/test_costs.py's 8-device
    script) on the port at world size 1: the counts read before
    ``compiled_costs``, then the identity, exactly, on each rung."""
    model = _sis()
    eng = make_engine(ename, model, window=16, device=CPU)
    st0 = model.init_state(prng.key(1, device=CPU), device=CPU)
    state, stats = eng.run(st0, 80, seed=2)
    iters = eng.comm_iteration_counts(stats)
    costs = eng.compiled_costs(state, seed=2)
    want = "execute_split" if ename == "sharded" else "execute_window"
    assert list(costs) == [want]
    chk = P.ledger_cross_check(costs, iters, stats["comm_bytes_total"])
    assert chk.ok and chk.ratio == 1.0 and chk.parsed_bytes > 0
    depth = 2 if ename == "sharded" else 1
    assert list(costs[want].collectives.bytes_by_depth()) == [depth]


def test_overlap_and_sequential_have_no_cost_targets():
    model = _sis()
    st0 = model.init_state(prng.key(1, device=CPU), device=CPU)
    for ename in ("wavefront_overlap", "sharded_overlap", "sequential"):
        eng = make_engine(ename, model, window=16, device=CPU)
        assert eng.compiled_costs(st0) is None, ename


def _kernels_on(monkeypatch):
    """Take the wave kernels' CUDA branches on CPU tensors, the plain
    versions standing in for the kernels."""
    from repro_torch.kernels.axelrod import ops as aops
    from repro_torch.kernels.axelrod.ref import axelrod_wave_ref
    from repro_torch.kernels.sir import ops as sops
    from repro_torch.kernels.sir.ref import sir_wave_plain

    monkeypatch.setattr(aops, "use_kernel", lambda t: True)
    monkeypatch.setattr(sops, "use_kernel", lambda t: True)
    monkeypatch.setattr(aops, "axelrod_wave_cuda",
                        lambda s, t, u, g, m, *, omega: axelrod_wave_ref(
                            s, t, u, g, m, omega=omega,
                            n_features=s.shape[1]))
    monkeypatch.setattr(sops, "sir_wave_cuda",
                        lambda st, sub, u, *, k, p_si, p_ir, p_rs:
                        sir_wave_plain(st, sub, u, n_agents=st.shape[0],
                                       k=k, subset_size=u.shape[1],
                                       p_si=p_si, p_ir=p_ir, p_rs=p_rs))
    return aops, sops


@pytest.mark.parametrize("family", ["axelrod", "sirs"])
def test_compiled_costs_count_the_wave_kernels(monkeypatch, family):
    """``compiled_costs`` of ``wavefront`` (the card's cost phase at a
    small size): the wave kernel reports one launch a wave of the
    window's schedule, its bytes and operations are ``work()``'s on the
    same inputs, and the caller's state is unchanged."""
    aops, sops = _kernels_on(monkeypatch)
    if family == "axelrod":
        model = PM.AxelrodModel(PM.AxelrodConfig(
            n_agents=200, n_features=5, q=3, omega=0.95), device=CPU)
    else:
        model = PM.SIRModel(PM.SIRConfig(n_agents=400, k=6,
                                         subset_size=25), device=CPU)
    eng = make_engine("wavefront", model, window=32, device=CPU)
    st0 = model.init_state(prng.key(1, device=CPU), device=CPU)
    before = {k: v.clone() for k, v in st0.items()}
    costs = eng.compiled_costs(st0, seed=5)
    for k, v in st0.items():
        assert torch.equal(v, before[k]), k
    (cost,) = costs.values()
    _, valid, levels = eng._schedule(prng.key(5, device=CPU), 0, 32)
    waves = int(levels.max()) + 1
    if family == "axelrod":
        name, one = "axelrod_wave", aops.work(32, 5)
    else:
        rec = model.create_tasks(prng.key(5, device=CPU), 0, 32)
        name, one = "sir_wave", sops.work(rec["subset"], n_agents=400, k=6,
                                          subset_size=25)
    assert cost.kernels == {name: {"launches": waves,
                                   "bytes": waves * one[0],
                                   "ops": waves * one[1]}}
    assert cost.flops >= waves * one[1]
    assert cost.bytes_accessed >= waves * one[0]
    assert cost.temp_bytes >= 0 and cost.device_peak_bytes is None


def test_kernel_wrappers_report_their_work(monkeypatch):
    """Each remaining wrapper's CUDA branch, taken on CPU tensors with
    the plain version standing in for its kernel, reports one launch and
    its ``work()`` to an installed recorder, and nothing without one."""
    from repro_torch.kernels.attach import ops as atops
    from repro_torch.kernels.attach import ref as atref
    from repro_torch.kernels.conflict import ops as cops
    from repro_torch.kernels.conflict.ref import (
        conflict_block_ref,
        conflict_matrix_ref,
    )
    from repro_torch.kernels.flash import ops as fops
    from repro_torch.kernels.levels import ops as lops
    from repro_torch.kernels.levels.ref import wave_levels_ref
    from repro_torch.kernels.wkv6 import ops as wops

    monkeypatch.setattr(cops, "conflict_matrix_cuda", conflict_matrix_ref)
    monkeypatch.setattr(cops, "conflict_block_cuda", conflict_block_ref)
    monkeypatch.setattr(lops, "wave_levels_cuda", wave_levels_ref)
    monkeypatch.setattr(atops, "attach_cuda", atref.attach_plain)
    monkeypatch.setattr(fops, "use_kernel", lambda t: True)
    monkeypatch.setattr(fops, "flash_attention_cuda",
                        lambda q, k, v, **kw: torch.zeros_like(q))
    monkeypatch.setattr(wops, "use_kernel", lambda t: True)
    monkeypatch.setattr(wops, "wkv6_cuda",
                        lambda r, *a, **kw: (torch.zeros_like(r), None))
    g = torch.Generator().manual_seed(0)
    reads = torch.randint(-1, 50, (40, 3), generator=g, dtype=torch.int32)
    writes = torch.randint(-1, 50, (40, 1), generator=g, dtype=torch.int32)
    valid = torch.arange(40) < 37
    q = torch.randn(1, 4, 16, 8, generator=g)
    kv = torch.randn(1, 2, 16, 8, generator=g)
    r = torch.randn(1, 2, 16, 8, generator=g)
    key = prng.key(3, device=CPU)

    def calls():
        conf = cops.conflict_matrix(reads, writes, valid, backend="cuda")
        cross = cops.conflict_block(reads, writes, reads, writes, valid,
                                    valid, backend="cuda")
        lops.wave_levels(conf, valid, backend="cuda")
        fops.flash_attention(q, kv, kv, causal=True)
        wops.wkv6(r, r, r, r, torch.zeros(2, 8))
        ends = torch.zeros(4 + 2 * 2 * 20, dtype=torch.int32)
        ends[:4] = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
        atops.attach_arrivals(key, ends, first=2, count=20, fill=4, m=2,
                              backend="cuda")
        return conf, cross

    calls()    # no recorder: nothing to report to
    r0 = atref.rounds_drawn
    with P.recording() as rec:
        conf, cross = calls()
    rounds = (atref.rounds_drawn - r0) // 2   # the wrapper's recount
    want = {
        "conflict_matrix": cops.work([(reads, writes, valid)], conf),
        "conflict_block": cops.work([(reads, writes, valid)] * 2, cross),
        "wave_levels": lops.work(40),
        "flash_attention": fops.work(1, 4, 2, 16, 16, 8, itemsize=4),
        "wkv6": wops.work(1, 2, 16, 8, False, itemsize=4),
        "attach": atops.work(20, 2, rounds),
    }
    assert rounds >= 20 * 2
    assert rec.kernels == {k: {"launches": 1, "bytes": b, "ops": o}
                           for k, (b, o) in want.items()}

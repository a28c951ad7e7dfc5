"""The port's serving engine, on the CPU: the reference's four serving
tests on the port alone, then the port's ``ServingEngine`` against the
reference's on the same parameters and requests — every request's
tokens, the finished order, the wave sizes, the iterations and the
``run_stats()`` dict must be equal, and a traced port run must record the
reference's ``run`` / ``schedule`` / ``execute`` events (name, phase,
category, thread and args; not the timestamps).

Sizes are the reduced smollm-360m (2 layers, d_model 128, float32);
weights come from the reference's ``init`` through the bridge. Greedy
tokens are compared exactly: the logits agree to ~1e-6 (test_torch_lm.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax  # noqa: E402

from repro import obs as JO  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import obs as PO  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels.flash import flash as flash_kernel  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.obs.trace import TID_LAYERS  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module")
def smollm():
    """(reference model, params, port model, params) at reduced size."""
    cfg = J_ARCHS["smollm-360m"].reduced()
    jm = j_build(cfg)
    jp = jm.init(jax.random.key(0))
    pm = build_model(ARCHS["smollm-360m"].reduced(), CPU)
    pp = bridge.lm_params_from_numpy(
        pm, jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, pm, pp


def _sequential(model, params, prompt, max_new, max_len=64):
    states = model.init_states(1, max_len)
    lp, states = model.prefill(params, {"tokens": torch.tensor(prompt)[None]},
                               states)
    toks = [int(torch.argmax(lp[0]))]
    for _ in range(max_new - 1):
        ld, states = model.decode_step(
            params, torch.tensor([[toks[-1]]], dtype=torch.int32), states)
        toks.append(int(torch.argmax(ld[0])))
    return toks


def _prompts(seed, sizes, vocab=512):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=n).astype(np.int32) for n in sizes]


# ------------------------------------------- the reference's serving tests
@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_engine_matches_sequential(smollm, impl):
    """Per-request sequential decoding — one-shot prefill through
    ``attn_impl`` ("pallas": the flash kernel's plain version here) —
    gives the engine's tokens (chunked prefill against the cache)."""
    _, _, pm, pp = smollm
    seq_model = build_model(pm.cfg.replace(attn_impl=impl), CPU)
    prompts = _prompts(0, (5, 9, 17, 3))
    refs = [_sequential(seq_model, pp, p, 6) for p in prompts]
    eng = ServingEngine(pm, pp, n_slots=3, max_len=64, prefill_chunk=8,
                        device=CPU)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    done = sorted(eng.run(), key=lambda r: r.rid)
    assert [r.out_tokens for r in done] == refs


def test_engine_mid_flight_arrival(smollm):
    """A request submitted while others decode joins the running waves
    without disturbing their outputs."""
    _, _, pm, pp = smollm
    p0, p1 = _prompts(1, (6, 4))
    ref0 = _sequential(pm, pp, p0, 8)
    ref1 = _sequential(pm, pp, p1, 5)
    eng = ServingEngine(pm, pp, n_slots=2, max_len=64, prefill_chunk=8,
                        device=CPU)
    eng.submit(Request(rid=0, prompt=p0, max_new_tokens=8))
    for _ in range(3):
        eng.step()
    eng.submit(Request(rid=1, prompt=p1, max_new_tokens=5))  # mid-flight
    done = sorted(eng.run(), key=lambda r: r.rid)
    assert done[0].out_tokens == ref0
    assert done[1].out_tokens == ref1


def test_engine_chunked_prefill_straggler(smollm):
    """A long prompt does not serialize the batch: the short request
    finishes during the long request's chunked prefill; the decode waves
    leave the long request's slot, mid-prefill, untouched."""
    _, _, pm, pp = smollm
    long_p, short_p = _prompts(2, (40, 4))
    eng = ServingEngine(pm, pp, n_slots=2, max_len=96, prefill_chunk=4,
                        device=CPU)  # 10 chunks for the long prompt
    eng.submit(Request(rid=0, prompt=long_p, max_new_tokens=2))
    eng.submit(Request(rid=1, prompt=short_p, max_new_tokens=3))
    eng.run()
    assert [r.rid for r in eng.finished][0] == 1
    assert max(eng.wave_sizes) >= 2
    by_rid = {r.rid: r for r in eng.finished}
    assert by_rid[0].out_tokens == _sequential(pm, pp, long_p, 2, 96)
    assert by_rid[1].out_tokens == _sequential(pm, pp, short_p, 3, 96)


def test_engine_eos_and_slot_reuse(smollm):
    _, _, pm, pp = smollm
    prompts = _prompts(3, (5,) * 6)
    eng = ServingEngine(pm, pp, n_slots=2, max_len=64, prefill_chunk=8,
                        device=CPU)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=4))
    done = eng.run()
    assert len(done) == 6
    assert all(len(r.out_tokens) == 4 for r in done)
    # a reused slot starts clean: each request equals its own sequential run
    for r in done:
        assert r.out_tokens == _sequential(pm, pp, prompts[r.rid], 4)


def test_decode_wave_leaves_other_slots_unchanged(smollm):
    """An idle slot and a slot mid-prefill come out of a decode wave with
    the same length, kpos, k, v and pos."""
    _, _, pm, pp = smollm
    long_p, short_p = _prompts(4, (20, 3))
    eng = ServingEngine(pm, pp, n_slots=3, max_len=64, prefill_chunk=4,
                        device=CPU)
    eng.submit(Request(rid=0, prompt=short_p, max_new_tokens=5))
    eng.submit(Request(rid=1, prompt=long_p, max_new_tokens=2))
    eng.step()                                  # both prefill a chunk
    before = bridge.lm_states_to_numpy(eng.states)
    eng.step()                                  # rid 0 decodes, 1 prefills
    after = bridge.lm_states_to_numpy(eng.states)
    slot_long, idle = 1, 2
    for name in ("k", "v", "length", "kpos"):
        b4, af = before["segs"][0]["kv"][name], after["segs"][0]["kv"][name]
        np.testing.assert_array_equal(af[:, idle], b4[:, idle])
        assert not np.array_equal(af[:, 0], b4[:, 0])   # the decoded slot
    assert after["pos"][idle] == before["pos"][idle] == 0
    assert after["pos"][slot_long] == before["pos"][slot_long] + 4


# ------------------------------------------------ against the reference
SCENARIOS = {
    "four_prompts": dict(sizes=(5, 9, 17, 3), new=(6, 6, 6, 6), slots=3,
                         max_len=64, chunk=8, seed=0),
    "straggler": dict(sizes=(40, 4), new=(2, 3), slots=2, max_len=96,
                      chunk=4, seed=2),
    "slot_reuse": dict(sizes=(5,) * 6, new=(4,) * 6, slots=2, max_len=64,
                       chunk=8, seed=3),
    "eos": dict(sizes=(7, 12, 4, 9, 30), new=(9, 5, 8, 6, 7), slots=3,
                max_len=64, chunk=8, seed=5, eos=True),
}


def _run_pair(smollm, sc, *, traced=False):
    jm, jp, pm, pp = smollm
    prompts = _prompts(sc["seed"], sc["sizes"])
    # EOS: a token the reference emits mid-run, so that requests end early
    eos = None
    je = JEngine(jm, jp, n_slots=sc["slots"], max_len=sc["max_len"],
                 prefill_chunk=sc["chunk"])
    pe = ServingEngine(pm, pp, n_slots=sc["slots"], max_len=sc["max_len"],
                       prefill_chunk=sc["chunk"], device=CPU)
    if sc.get("eos"):
        probe = _sequential(pm, pp, prompts[0], sc["new"][0])
        eos = probe[len(probe) // 2]
    for i, (p, n) in enumerate(zip(prompts, sc["new"])):
        je.submit(JRequest(rid=i, prompt=p, max_new_tokens=n, eos_token=eos))
        pe.submit(Request(rid=i, prompt=p, max_new_tokens=n, eos_token=eos))
    if not traced:
        return je, je.run(), pe, pe.run(), None, None
    with JO.tracing() as jtr:
        jd = je.run()
    with PO.tracing() as ptr:
        pd = pe.run()
    return je, jd, pe, pd, jtr, ptr


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_matches_reference_engine(smollm, name):
    je, jd, pe, pd, _, _ = _run_pair(smollm, SCENARIOS[name])
    assert [r.rid for r in pd] == [r.rid for r in jd]
    assert [r.out_tokens for r in pd] == [r.out_tokens for r in jd]
    assert pe.wave_sizes == je.wave_sizes
    assert pe.iterations == je.iterations
    assert pe.run_stats() == je.run_stats()
    if name == "eos":
        assert any(len(r.out_tokens) < r.max_new_tokens for r in pd)


def test_windowed_engine_matches_reference_engine():
    """A sliding-window model, reduced h2o-danube-3-4b (window 64): the
    same tokens, waves, iterations and stats as the reference's engine,
    with prompts below the window (chunks of 8 never wrap a ring onto
    keys they still see) whose decoding runs past it (up to 60 + 12
    tokens). Past the window in prefill the port's engine keeps keys the
    reference's ring loses (``serving/engine.py``), so that case is held
    against one-shot prefill (test_torch_hymba.py) instead."""
    cfg = J_ARCHS["h2o-danube-3-4b"].reduced()
    assert cfg.sliding_window == 64
    jm = j_build(cfg)
    jp = jm.init(jax.random.key(0))
    pm = build_model(ARCHS["h2o-danube-3-4b"].reduced(), CPU)
    pp = bridge.lm_params_from_numpy(
        pm, jax.tree_util.tree_map(np.asarray, jp))
    je = JEngine(jm, jp, n_slots=3, max_len=96, prefill_chunk=8)
    pe = ServingEngine(pm, pp, n_slots=3, max_len=96, prefill_chunk=8,
                       device=CPU)
    assert pe.states["segs"][0]["kv"].k.shape \
        == je.states["segs"][0]["kv"].k.shape
    for i, p in enumerate(_prompts(8, (60, 9, 45, 3, 57))):
        je.submit(JRequest(rid=i, prompt=p, max_new_tokens=12))
        pe.submit(Request(rid=i, prompt=p, max_new_tokens=12))
    jd, pd = je.run(), pe.run()
    assert [r.rid for r in pd] == [r.rid for r in jd]
    assert [r.out_tokens for r in pd] == [r.out_tokens for r in jd]
    assert pe.wave_sizes == je.wave_sizes
    assert pe.iterations == je.iterations
    assert pe.run_stats() == je.run_stats()


def _by_thread(events):
    """Events per reference thread (tids 0-2); the port's layers thread
    (tid 3) is checked on its own."""
    out = {}
    for e in events:
        if e["tid"] != TID_LAYERS:
            out.setdefault(e["tid"], []).append(
                {k: e.get(k) for k in ("name", "ph", "cat", "pid", "args")})
    return out


def test_traced_engine_matches_reference_events(smollm):
    je, jd, pe, pd, jtr, ptr = _run_pair(smollm, SCENARIOS["straggler"],
                                         traced=True)
    assert [r.out_tokens for r in pd] == [r.out_tokens for r in jd]
    payload = ptr.export()
    PO.validate_chrome_trace(payload)
    assert _by_thread(payload["traceEvents"]) == _by_thread(jtr.events())
    names = [e["name"] for e in payload["traceEvents"] if e["ph"] == "B"]
    assert names.count("run") == 1
    assert names.count("execute") == pe.iterations
    assert names.count("schedule") >= pe.iterations
    # the layers thread: the scheduler's record check and levels, and one
    # span per prefill chunk and decode wave, each labelled with its
    # iteration (the last schedule finds no wave)
    layers = [e for e in payload["traceEvents"]
              if e["tid"] == TID_LAYERS and e["ph"] == "X"]
    assert {e["name"] for e in layers} == {
        "protocol.conflict_predicate", "protocol.levels",
        "protocol.prefill_chunk", "protocol.decode_wave"}
    assert all(0 <= e["args"]["window"] <= pe.iterations for e in layers)
    assert (sum(e["name"] == "protocol.decode_wave" for e in layers)
            == sum(1 for e in jtr.events() if e["name"] == "execute"
                   and e["ph"] == "B" and e["args"]["decodes"]))


def test_untraced_engine_opens_no_span(smollm, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a trace hook ran with tracing off")

    monkeypatch.setattr(PO.SpanTracer, "span", refuse)
    monkeypatch.setattr(engine_mod, "block_all", refuse)
    _, _, pm, pp = smollm
    eng = ServingEngine(pm, pp, n_slots=2, max_len=64, prefill_chunk=8,
                        device=CPU)
    for i, p in enumerate(_prompts(6, (4, 6))):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=3))
    assert len(eng.run()) == 2


def test_engine_runs_on_the_levels_path_and_no_flash(smollm, monkeypatch):
    """The scheduler goes through the port's records; the engine's own
    prefill is the chunked continuation path, so it launches no flash
    kernel (only the sequential one-shot prefill reaches it)."""
    from repro_torch.core import records

    calls = []
    real = records.wave_levels
    monkeypatch.setattr(engine_mod, "wave_levels",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, _, pm, pp = smollm
    n0 = flash_kernel.launches
    eng = ServingEngine(pm, pp, n_slots=2, max_len=64, prefill_chunk=8,
                        device=CPU)
    for i, p in enumerate(_prompts(7, (9, 3))):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=3))
    eng.run()
    assert len(calls) == eng.iterations
    assert flash_kernel.launches == n0


def test_serve_launcher_on_cpu(capsys):
    from repro_torch.launch import serve

    finished = serve.main(["--arch", "smollm-360m", "--reduced", "--device",
                           "cpu", "--requests", "3", "--max-new", "4",
                           "--max-len", "32", "--prefill-chunk", "8"])
    assert len(finished) == 3
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "on cpu" in out

"""The port's RWKV6 path against the JAX package's, on the CPU.

Inputs are made with numpy from a seed; weights come from the reference's
``Model.init`` and are carried across by ``bridge.lm_params_from_numpy``.
Sizes are the reduced rwkv6-3b (2 layers, d_model 128, 4 WKV heads of 32,
vocab 512, float32).

Tolerances, and why:
  * the plain ``wkv6`` (what the CUDA kernel is held to on the card)
    against the reference's Pallas kernel in interpret mode: ``atol=1e-4,
    rtol=1e-4`` — the TPU kernel's chunked form goes through log w and
    back, a few float32 roundings per step (measured ≤ 3.5e-5 on outputs
    up to 6); the reference's own ``test_wkv6_sweep`` allows 1e-3;
  * against the reference's per-step ``wkv6_ref`` and ``wkv6_chunked_jnp``
    with a carried state, and the decode step: ``atol=1e-5, rtol=1e-5`` —
    the same arithmetic, summed in another order (measured ≤ 7.2e-7);
  * model logits and states after prefill and decode: ``atol=1e-5,
    rtol=1e-5`` — the reference's own "ref" and "chunked" routes differ by
    5.1e-7 in last-token logits on a 70-token prompt; integer ``pos`` is
    compared exactly; greedy tokens equal.

Traps of the port held here: ``jnp.var`` is the population variance
(``torch.var`` defaults to ``correction=1``); the groupnorm's epsilon is
64e-5; ``w`` is cast to the activations' dtype before the WKV; the new
token-shift ``last`` is the last row of the *normed* input.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.kernels.wkv6.ops import wkv6 as j_wkv6  # noqa: E402
from repro.kernels.wkv6.ops import wkv6_decode_step as j_step  # noqa: E402
from repro.kernels.wkv6.ref import wkv6_ref as j_wkv6_ref  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro.models.rwkv6 import wkv6_chunked_jnp  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6 as wkv6_kernel  # noqa: E402
from repro_torch.kernels.wkv6.ops import wkv6, wkv6_decode_step  # noqa: E402
from repro_torch.kernels.wkv6.ref import wkv6_ref  # noqa: E402
from repro_torch.models import rwkv6 as PR  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

CPU = "cpu"
ARCH = "rwkv6-3b"
KERNEL = dict(atol=1e-4, rtol=1e-4)
EXACT_ORDER = dict(atol=1e-5, rtol=1e-5)
LOGITS = dict(atol=1e-5, rtol=1e-5)
IMPLS = ["ref", "chunked", "pallas"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def rwkv():
    """(reference model, its params, the same params in the port)."""
    jm = j_build(J_ARCHS[ARCH].reduced())
    jp = jm.init(jax.random.key(0))
    pm = build_model(ARCHS[ARCH].reduced(), CPU)
    return jm, jp, bridge.lm_params_from_numpy(pm, _np(jp))


def _models(impl, ref_impl="chunked"):
    """(reference model through ``ref_impl``, port model through
    ``impl``), same reduced config."""
    return (j_build(J_ARCHS[ARCH].reduced().replace(attn_impl=ref_impl)),
            build_model(ARCHS[ARCH].reduced().replace(attn_impl=impl), CPU))


def _wkv_inputs(b, h, t, d, seed, *, s0=False):
    """The reference sweep's inputs: std 0.4, w = exp(-exp(N(0, 0.4)))."""
    rng = np.random.RandomState(seed)
    f = lambda *sh: rng.randn(*sh).astype(np.float32) * 0.4  # noqa: E731
    r, k, v = f(b, h, t, d), f(b, h, t, d), f(b, h, t, d)
    w = np.exp(-np.exp(f(b, h, t, d)))
    u = f(h, d)
    return r, k, v, w, u, (f(b, h, d, d) if s0 else None)


def _both(fn_j, fn_p, r, k, v, w, u, s0, **kw):
    js = {} if s0 is None else {"s0": jnp.asarray(s0)}
    ps = {} if s0 is None else {"s0": torch.tensor(s0)}
    jo, jsf = fn_j(*(jnp.asarray(x) for x in (r, k, v, w, u)), **js, **kw)
    po, psf = fn_p(*(torch.tensor(x) for x in (r, k, v, w, u)), **ps, **kw)
    return (np.asarray(jo), np.asarray(jsf)), (po.numpy(), psf.numpy())


# ------------------------------------------------------------------ wkv6
@pytest.mark.parametrize("b,h,t,d", [(1, 2, 128, 64), (2, 3, 256, 64),
                                     (1, 1, 64, 128), (1, 2, 32, 64)])
def test_wkv6_plain_matches_reference_kernel(b, h, t, d):
    """test_wkv6_sweep's shapes: the port's ``wkv6`` on CPU tensors (the
    plain version, no launch) against the Pallas kernel in interpret
    mode."""
    args = _wkv_inputs(b, h, t, d, seed=t + d)
    n0 = wkv6_kernel.launches
    (jo, jsf), (po, psf) = _both(j_wkv6, wkv6, *args)
    assert wkv6_kernel.launches == n0
    np.testing.assert_allclose(po, jo, **KERNEL)
    np.testing.assert_allclose(psf, jsf, **KERNEL)


@pytest.mark.parametrize("t", [1, 37, 129])
def test_wkv6_plain_with_state_matches_reference_ref(t):
    """A carried state and ragged T (the engine's last chunk, a decode
    step), which the reference's kernel wrapper does not take: against
    the reference's ``wkv6_ref``."""
    (jo, jsf), (po, psf) = _both(j_wkv6_ref, wkv6,
                                 *_wkv_inputs(2, 3, t, 32, t, s0=True))
    np.testing.assert_allclose(po, jo, **EXACT_ORDER)
    np.testing.assert_allclose(psf, jsf, **EXACT_ORDER)


@pytest.mark.parametrize("t,chunk", [(96, 32), (70, 64), (37, 64)])
def test_wkv6_chunked_matches_reference(t, chunk):
    """The model's "chunked" route with a carried state, including the
    reference's halving of the chunk for a T it does not divide."""
    (jo, jsf), (po, psf) = _both(wkv6_chunked_jnp, PR.wkv6_chunked,
                                 *_wkv_inputs(2, 2, t, 32, t, s0=True),
                                 chunk=chunk)
    np.testing.assert_allclose(po, jo, **EXACT_ORDER)
    np.testing.assert_allclose(psf, jsf, **EXACT_ORDER)


def test_wkv6_decode_step_matches_reference():
    r, k, v, w, u, s0 = _wkv_inputs(3, 4, 1, 32, 5, s0=True)
    one = [x[:, :, 0] for x in (r, k, v, w)]
    jo, js = j_step(jnp.asarray(s0), *(jnp.asarray(x) for x in one),
                    jnp.asarray(u))
    po, ps = wkv6_decode_step(torch.tensor(s0),
                              *(torch.tensor(x) for x in one),
                              torch.tensor(u))
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), **EXACT_ORDER)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), **EXACT_ORDER)
    # one step of the recurrence is the T = 1 scan
    o1, s1 = wkv6_ref(*(torch.tensor(x) for x in (r, k, v, w, u)),
                      s0=torch.tensor(s0))
    assert torch.equal(o1[:, :, 0], po) and torch.equal(s1, ps)


def _wrong(r, k, v, w, u, s0, *, drop_u=False, decay_first=False):
    """The recurrence with one fault: no ``u`` bonus, or the decay applied
    to S before the read instead of after."""
    s = s0.clone()
    o = torch.empty_like(r)
    for i in range(r.shape[2]):
        rt, kt, vt, wt = (x[:, :, i] for x in (r, k, v, w))
        if decay_first:
            s = wt[..., None] * s
        bonus = 0.0 if drop_u else (rt * u * kt).sum(-1, keepdim=True)
        o[:, :, i] = torch.einsum("bhk,bhkd->bhd", rt, s) + bonus * vt
        if not decay_first:
            s = wt[..., None] * s
        s = s + kt[..., None] * vt[..., None, :]
    return o


def test_wkv6_tolerance_rejects_wrong_recurrences():
    """The tolerance the plain version is held to rejects a kernel that
    drops the bonus and one that decays before the read."""
    args = [torch.tensor(x) for x in _wkv_inputs(1, 2, 64, 32, 3, s0=True)]
    want, _ = wkv6_ref(*args[:5], s0=args[5])
    for kw in ({"drop_u": True}, {"decay_first": True}):
        bad = _wrong(*args, **kw)
        assert not torch.allclose(bad, want, **KERNEL), kw
    assert torch.allclose(_wrong(*args), want, **EXACT_ORDER)


def test_wkv6_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's binding launches or raises: a CPU tensor is refused,
    never computed another way."""
    r = torch.zeros((2, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_kernel.wkv6_cuda(r, r, r, r, torch.zeros((2, 8)), n_heads=2)


# ----------------------------------------------------------------- layers
def test_time_mix_groupnorm_uses_population_variance(rwkv):
    """One time-mix layer on a fixed input, against the reference's (the
    groupnorm's variance and epsilon, the decay's cast, the new last)."""
    from repro.models import rwkv6 as JR

    jm, jp, pp = rwkv
    rng = np.random.RandomState(4)
    x = rng.randn(2, 9, 128).astype(np.float32)
    jtm = jax.tree_util.tree_map(lambda a: a[0], jp["segments"][0])["rwkv"]
    jout, jst = JR.rwkv_time_mix(jtm["tm"], jnp.asarray(x), jm.cfg,
                                 impl="ref")
    ptm = pp.segments[0][0].rwkv.tm
    st = {"last": torch.zeros((2, 1, 128)), "s": torch.zeros((2, 4, 32, 32))}
    out = PR.rwkv_time_mix(ptm, torch.tensor(x), jm.cfg, state=st,
                           impl="ref")
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **LOGITS)
    np.testing.assert_array_equal(st["last"].numpy(), x[:, -1:])
    np.testing.assert_allclose(st["s"].numpy(), np.asarray(jst["s"]),
                               **EXACT_ORDER)
    assert PR.GROUPNORM_EPS == 64e-5


def _greedy(logits):
    return np.asarray(np.argmax(np.asarray(logits), axis=-1), np.int32)


def _assert_states(ps, js):
    """Every state leaf of the port against the reference's."""
    back = bridge.lm_states_to_numpy(ps)
    for part, leaves in (("tm", ("last", "s")), ("cm", ("last",))):
        for leaf in leaves:
            np.testing.assert_allclose(
                back["segs"][0][part][leaf],
                np.asarray(js["segs"][0][part][leaf]), **LOGITS,
                err_msg=f"{part}.{leaf}")
    np.testing.assert_array_equal(back["pos"], np.asarray(js["pos"]))


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("ref_impl", ["ref", "chunked"])
@pytest.mark.parametrize("impl", IMPLS)
def test_model_prefill_and_decode_match_reference(rwkv, impl, ref_impl):
    """One-shot prefill of a 70-token prompt (B = 2), then three decode
    steps: last-token logits and every state leaf."""
    _, jp, pp = rwkv
    jm, pm = _models(impl, ref_impl)
    rng = np.random.RandomState(7)
    toks = rng.randint(0, 512, size=(2, 70)).astype(np.int32)
    jl, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        jm.init_states(2, 96))
    pl_, ps = pm.prefill(pp, {"tokens": torch.tensor(toks)},
                         pm.init_states(2, 96))
    np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **LOGITS)
    _assert_states(ps, js)
    for _ in range(3):
        tok = _greedy(jl)[:, None]
        np.testing.assert_array_equal(_greedy(pl_)[:, None], tok)
        jl, js = jm.decode_step(jp, jnp.asarray(tok), js)
        pl_, ps = pm.decode_step(pp, torch.tensor(tok), ps)
        np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **LOGITS)
    _assert_states(ps, js)


@pytest.mark.parametrize("impl", IMPLS)
def test_model_chunked_prefill_matches_reference(rwkv, impl):
    """The serving engine's continuation path: the prompt in chunks of 16
    (the last one ragged) carrying the state, then decode; against the
    reference's one-shot "ref" model."""
    _, jp, pp = rwkv
    jm, pm = _models(impl, "ref")
    rng = np.random.RandomState(8)
    toks = rng.randint(0, 512, size=(1, 70)).astype(np.int32)
    jl, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        jm.init_states(1, 96))
    ps = pm.init_states(1, 96)
    for c0 in range(0, 70, 16):
        pl_, ps = pm.prefill(pp, {"tokens": torch.tensor(
            toks[:, c0:c0 + 16])}, ps, chunked=True, include_prefix=c0 == 0)
    np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **LOGITS)
    _assert_states(ps, js)
    for _ in range(2):
        tok = _greedy(jl)[:, None]
        jl, js = jm.decode_step(jp, jnp.asarray(tok), js)
        pl_, ps = pm.decode_step(pp, torch.tensor(tok), ps)
        np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **LOGITS)
    _assert_states(ps, js)


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_commit_advances_only_committed_rows(rwkv, impl):
    """``decode_step(commit=)``: committed rows equal an unmasked step,
    the others keep ``s``, both ``last``s and ``pos``."""
    _, _, pp = rwkv
    _, pm = _models(impl)
    toks = np.random.RandomState(9).randint(0, 512, size=(3, 11)).astype(
        np.int32)
    full = pm.prefill(pp, {"tokens": torch.tensor(toks)},
                      pm.init_states(3, 32))[1]
    masked = bridge.lm_states_from_numpy(bridge.lm_states_to_numpy(full),
                                         CPU)
    before = bridge.lm_states_to_numpy(full)
    tok = torch.tensor([[3], [4], [5]], dtype=torch.int32)
    lf, _ = pm.decode_step(pp, tok, full)
    lm_, _ = pm.decode_step(pp, tok, masked,
                            commit=torch.tensor([True, False, True]))
    assert torch.equal(lm_, lf)              # every row is computed
    after, want = (bridge.lm_states_to_numpy(x) for x in (masked, full))
    for part, leaf in (("tm", "last"), ("tm", "s"), ("cm", "last")):
        got = after["segs"][0][part][leaf]
        np.testing.assert_array_equal(got[:, 1],
                                      before["segs"][0][part][leaf][:, 1])
        np.testing.assert_array_equal(got[:, [0, 2]],
                                      want["segs"][0][part][leaf][:, [0, 2]])
    np.testing.assert_array_equal(after["pos"], [12, 11, 12])


def test_apply_train_and_loss_match_reference(rwkv):
    jm, jp, pp = rwkv
    pm = build_model(ARCHS[ARCH].reduced(), CPU)
    rng = np.random.RandomState(10)
    batch = {"tokens": rng.randint(0, 512, size=(2, 32)).astype(np.int32),
             "labels": rng.randint(0, 512, size=(2, 32)).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pb = {k: torch.tensor(v) for k, v in batch.items()}
    jlog, _ = jm.apply_train(jp, jb)
    plog, _ = pm.apply_train(pp, pb)
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **LOGITS)
    jloss, _ = jm.loss(jp, jb)
    ploss, metrics = pm.loss(pp, pb)
    np.testing.assert_allclose(float(ploss), float(jloss), **EXACT_ORDER)
    assert set(metrics) == {"ce"}


def test_states_round_trip_through_bridge(rwkv):
    jm, jp, pp = rwkv
    pm = build_model(ARCHS[ARCH].reduced(), CPU)
    toks = np.arange(40, dtype=np.int32)[None] % 512
    _, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                       jm.init_states(1, 64))
    ps = bridge.lm_states_from_numpy(_np(js), CPU)
    assert ps["segs"][0]["tm"]["s"].shape == (2, 1, 4, 32, 32)  # stacked
    back = bridge.lm_states_to_numpy(ps)
    for part, leaf in (("tm", "last"), ("tm", "s"), ("cm", "last")):
        np.testing.assert_array_equal(back["segs"][0][part][leaf],
                                      np.asarray(js["segs"][0][part][leaf]))
    # the port continues from the reference's states as the reference does
    jl, _ = jm.decode_step(jp, jnp.asarray([[5]], jnp.int32), js)
    pl_, _ = pm.decode_step(pp, torch.tensor([[5]], dtype=torch.int32), ps)
    np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **LOGITS)


def test_param_tree_matches_reference_paths(rwkv):
    """Every leaf of the reference's tree is one parameter of the port,
    at the reference's path, with its shape; ``Model.init`` draws the
    same tree (the lerps in [0, 1))."""
    _, jp, pp = rwkv
    names = dict(pp.named_parameters())
    n = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jp))
    assert sum(p.numel() for p in names.values()) == n
    tm = [f"segments.0.1.rwkv.tm.{k}" for k in (
        "mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "wr.w", "wk.w", "wv.w",
        "wg.w", "wo.w", "w0", "w_lora_a.w", "w_lora_b.w", "u", "ln_scale")]
    cm = [f"segments.0.1.rwkv.cm.{k}" for k in ("mu", "wk.w", "wv.w")]
    assert set(tm + cm + ["segments.0.1.norm1.scale",
                          "segments.0.1.norm2.scale", "lm_head.w"]) \
        <= set(names)
    assert names["segments.0.0.rwkv.tm.u"].shape == (4, 32)
    fresh = dict(build_model(ARCHS[ARCH].reduced(), CPU).init(
        1, device=CPU).named_parameters())
    assert {k: v.shape for k, v in fresh.items()} == \
        {k: v.shape for k, v in names.items()}
    mu = fresh["segments.0.0.rwkv.tm.mu_r"]
    assert 0.0 <= float(mu.min()) and float(mu.max()) < 1.0
    assert torch.equal(fresh["segments.0.0.rwkv.tm.w0"],
                       torch.full((128,), -1.0))


# ---------------------------------------------------------------- serving
def _prompts(seed, sizes, vocab=512):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=n).astype(np.int32) for n in sizes]


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


SCENARIOS = {
    "four_prompts": dict(sizes=(5, 9, 17, 3), new=(6, 6, 6, 6), slots=3,
                         max_len=64, chunk=8, seed=0),
    "straggler": dict(sizes=(40, 4), new=(2, 3), slots=2, max_len=96,
                      chunk=4, seed=2),
    "slot_reuse": dict(sizes=(5,) * 6, new=(4,) * 6, slots=2, max_len=64,
                       chunk=8, seed=3),
    "eos": dict(sizes=(7, 12, 4, 9, 30), new=(9, 5, 8, 6, 7), slots=3,
                max_len=64, chunk=8, seed=5, eos=True),
    "mid_flight": dict(sizes=(6, 4), new=(8, 5), slots=2, max_len=64,
                       chunk=8, seed=1, late=(1, 3)),
}


def _run(engine, sc, prompts, eos, req_cls):
    """Submit the scenario's requests (a late one after ``late[1]``
    iterations) and run to the end."""
    late = sc.get("late", (None, 0))
    for i, (p, n) in enumerate(zip(prompts, sc["new"])):
        if i != late[0]:
            engine.submit(req_cls(rid=i, prompt=p, max_new_tokens=n,
                                  eos_token=eos))
    if late[0] is not None:
        for _ in range(late[1]):
            engine.step()
        engine.submit(req_cls(rid=late[0], prompt=prompts[late[0]],
                              max_new_tokens=sc["new"][late[0]],
                              eos_token=eos))
    return engine.run()


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_matches_reference_engine(rwkv, name, impl):
    """The port's engine (its time-mix through ``impl``) against the
    reference's, request for request: tokens, finished order, waves,
    iterations and stats."""
    jm, jp, pp = rwkv
    pm = build_model(ARCHS[ARCH].reduced().replace(attn_impl=impl), CPU)
    sc = SCENARIOS[name]
    prompts = _prompts(sc["seed"], sc["sizes"])
    eos = None
    if sc.get("eos"):
        probe = _sequential(pm, pp, prompts[0], sc["new"][0])
        eos = probe[len(probe) // 2]
    je = JEngine(jm, jp, n_slots=sc["slots"], max_len=sc["max_len"],
                 prefill_chunk=sc["chunk"])
    pe = ServingEngine(pm, pp, n_slots=sc["slots"], max_len=sc["max_len"],
                       prefill_chunk=sc["chunk"], device=CPU)
    jd = _run(je, sc, prompts, eos, JRequest)
    pd = _run(pe, sc, prompts, eos, Request)
    assert [r.rid for r in pd] == [r.rid for r in jd]
    assert [r.out_tokens for r in pd] == [r.out_tokens for r in jd]
    assert pe.wave_sizes == je.wave_sizes
    assert pe.iterations == je.iterations
    assert pe.run_stats() == je.run_stats()
    # and each request equals its own sequential decoding (slots reset)
    for r in pd:
        if r.eos_token is None:
            assert r.out_tokens == _sequential(
                pm, pp, prompts[r.rid], sc["new"][r.rid], sc["max_len"])
    if name == "eos":
        assert any(len(r.out_tokens) < r.max_new_tokens for r in pd)


def test_decode_wave_leaves_other_slots_unchanged(rwkv):
    """An idle slot and a slot mid-prefill come out of a decode wave with
    the same ``s``, ``last``s and ``pos``."""
    _, _, pp = rwkv
    pm = build_model(ARCHS[ARCH].reduced().replace(attn_impl="pallas"), CPU)
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
    for part, leaf in (("tm", "last"), ("tm", "s"), ("cm", "last")):
        b4 = before["segs"][0][part][leaf]
        af = after["segs"][0][part][leaf]
        np.testing.assert_array_equal(af[:, idle], b4[:, idle])
        assert not np.array_equal(af[:, 0], b4[:, 0])   # the decoded slot
        assert not np.array_equal(af[:, slot_long], b4[:, slot_long])
    assert after["pos"][idle] == before["pos"][idle] == 0
    assert after["pos"][slot_long] == before["pos"][slot_long] + 4


def test_engine_runs_wkv6_on_every_time_mix(rwkv, monkeypatch):
    """With ``attn_impl="pallas"`` every time-mix of the engine's run goes
    through ``kernels/wkv6/ops.py::wkv6``: one call per layer and prefill
    chunk or decode wave (the count the card's launch counter must show);
    the other routes never reach it."""
    _, _, pp = rwkv
    real, calls, waves = PR.wkv6, [], []
    monkeypatch.setattr(PR, "wkv6", lambda *a, **k: calls.append(
        tuple(a[0].shape)) or real(*a, **k))
    real_wave = ServingEngine._exec_decode_wave
    monkeypatch.setattr(ServingEngine, "_exec_decode_wave",
                        lambda self, t: waves.append(len(t)) or
                        real_wave(self, t))
    for impl in ("pallas", "chunked"):
        calls.clear()
        waves.clear()
        pm = build_model(ARCHS[ARCH].reduced().replace(attn_impl=impl), CPU)
        eng = ServingEngine(pm, pp, n_slots=2, max_len=64, prefill_chunk=8,
                            device=CPU)
        for i, p in enumerate(_prompts(11, (19, 5, 9))):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=4))
        eng.run()
        if impl == "chunked":
            assert calls == [] and waves
            continue
        n = pm.cfg.n_layers
        assert len(calls) == n * (eng.prefill_tasks + len(waves))
        prefill = [c for c in calls if c[0] == 1]        # one slot's view
        assert len(prefill) == n * eng.prefill_tasks
        # chunks of 8 with ragged ends: 19 = 8 + 8 + 3, 5, 9 = 8 + 1
        assert sorted({c[2] for c in prefill}) == [1, 3, 5, 8]
        assert all(c[0] == 2 and c[2] == 1 for c in calls if c[0] != 1)


def test_serve_launcher_on_cpu(capsys):
    from repro_torch.launch import serve

    finished = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--requests", "3", "--max-new", "4",
                           "--max-len", "32", "--prefill-chunk", "8"])
    assert len(finished) == 3
    assert all(len(r.out_tokens) == 4 for r in finished)
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "on cpu" in out

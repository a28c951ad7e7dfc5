"""The port's hymba path (hybrid: parallel attention + SSD heads, 8 meta
tokens after reduction) against the JAX package's, on the CPU.

Reduced hymba-1.5b: 2 layers (a global segment, then a window-64
segment), d_model 128, 4 + 2 heads of 32, SSM 4 heads × 32 with state 8,
chunk 32, float32. Weights come from the reference's ``Model.init`` and
are carried across by ``bridge.lm_params_from_numpy``; token ids are
drawn with numpy from a seed. The reference's runs are jitted once per
module where they are shared.

Tolerances, and why:
  * logits (train, prefill, chunked prefill, decode): ``atol=1e-4,
    rtol=1e-4`` — two layers of float32 sums in another order, through
    the vocabulary projection (test_torch_lm.py's model tolerance);
  * loss and every gradient leaf: ``rtol=1e-5, atol=1e-6``
    (test_torch_train.py's); one train step's parameters ``rtol=1e-5,
    atol=2e-5`` (2 % of the peak lr; see test_torch_train.py);
  * states after prefill and decode: KV and SSM ``atol=1e-5, rtol=1e-5``,
    ``length``, ``kpos`` and ``pos`` exactly;
  * the serving engine's tokens: equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.train import step as j_step  # noqa: E402
from repro.utils import pytree as j_pytree  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.train.step import TrainHParams, make_train_step  # noqa: E402

ARCH = "hymba-1.5b"
CPU = "cpu"
LOGITS = dict(atol=1e-4, rtol=1e-4)
ACT = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(rtol=1e-5, atol=1e-6)
PARAMS_TOL = dict(rtol=1e-5, atol=2e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree) -> dict:
    out = {}
    j_pytree.tree_map_with_path_str(
        lambda p, x: out.__setitem__(p, np.asarray(x)), tree)
    return out


def _assert_trees(got, want, label, **tol):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want), label
    for p, w in want.items():
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(got[p], w, err_msg=f"{label} {p}")
        else:
            np.testing.assert_allclose(got[p], w, err_msg=f"{label} {p}",
                                       **tol)


@pytest.fixture(scope="module")
def ref():
    """The reference's reduced hymba and its parameters."""
    jm = j_build(J_ARCHS[ARCH].reduced())
    return jm, jm.init(jax.random.key(0))


def _port(ref, **changes):
    jm, jp = ref
    pm = build_model(ARCHS[ARCH].reduced().replace(**changes), CPU)
    return pm, bridge.lm_params_from_numpy(pm, _np(jp))


def _j_model(**changes):
    return j_build(J_ARCHS[ARCH].reduced().replace(**changes))


def _tokens(seed, shape, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, size=shape).astype(
        np.int32)


def test_param_tree_and_states_match_reference_layout(ref):
    """The port's tree holds the reference's leaves (``prefix``, the
    ``hymba.ssm`` names, one global and one window segment) with their
    shapes; the serving states hold ``{"kv", "ssm"}`` stacked per
    segment, and go through the bridge both ways."""
    jm, jp = ref
    pm, pp = _port(ref)
    names = dict(pp.named_parameters())
    assert names["prefix"].shape == (8, 128)
    for leaf in ("w_x.w", "w_z.w", "w_b.w", "w_c.w", "w_dt.w", "dt_bias",
                 "a_log", "d_skip", "w_out.w"):
        assert f"segments.1.0.hymba.ssm.{leaf}" in names
    assert [s.is_global for s in pm.segments] == [True, False]
    fresh = dict(pm.init(1, device=CPU).named_parameters())
    assert {k: v.shape for k, v in fresh.items()} == \
        {k: v.shape for k, v in names.items()}
    _, js = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(
        _tokens(1, (2, 20)))}, jm.init_states(2, 64))
    ps = bridge.lm_states_from_numpy(_np(js), CPU)
    assert ps["segs"][0]["ssm"].shape == (1, 2, 4, 32, 8)
    assert ps["segs"][1]["kv"].k.shape[3] == 64          # the window ring
    _assert_trees(bridge.lm_states_to_numpy(ps), _np(js), "states")


@pytest.mark.parametrize("impl", ["ref", "chunked"])
def test_apply_train_loss_and_grads_match_reference(ref, impl):
    jm, jp = ref
    jm = _j_model(attn_impl=impl)
    pm, pp = _port(ref, attn_impl=impl)
    toks = _tokens(2, (2, 24))
    labels = _tokens(3, (2, 24))
    batch = {"tokens": toks, "labels": labels}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pb = {k: torch.tensor(v) for k, v in batch.items()}
    jl, _ = jax.jit(jm.apply_train)(jp, jb)
    with torch.no_grad():
        pl, _ = pm.apply_train(pp, pb)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGITS)
    (jloss, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, jb)
    pp.requires_grad_(True)
    named = dict(pp.named_parameters())
    loss, metrics = pm.loss(pp, pb)
    grads = torch.autograd.grad(loss, list(named.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), **GRAD)
    assert set(metrics) == {"ce"}
    _assert_trees(bridge.lm_params_to_numpy(dict(zip(named, grads))),
                  _np(jg), "grads", **GRAD)


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_prefill_and_masked_decode_match_reference(ref, impl):
    """One-shot prefill (with "pallas" the reference's Pallas kernel in
    interpret mode against the port's flash wrapper, its plain version on
    the CPU) of 24 tokens + 8 meta tokens, then four decode steps, the
    third committing row 0 only (the reference's masked merge); logits
    (of every row: one that does not commit attends as the reference's
    does before its merge) and states after each."""
    _, jp = ref
    jm = _j_model(attn_impl=impl)
    pm, pp = _port(ref, attn_impl=impl)
    toks = _tokens(4, (2, 24))
    js = jm.init_states(2, 96)
    jl, js = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)}, js)
    ps = pm.init_states(2, 96)
    pl, ps = pm.prefill(pp, {"tokens": torch.tensor(toks)}, ps)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGITS)
    assert ps["pos"].tolist() == [32, 32]              # meta tokens count
    decode = jax.jit(jm.decode_step)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    assert np.array_equal(tok[:, 0], pl.numpy().argmax(-1))
    for step, commit in enumerate([None, None, [True, False], None]):
        jl, jnew = decode(jp, jnp.asarray(tok), js)
        if commit is not None:       # the reference engine's masked merge
            js = _merge(js, jnew, np.asarray(commit))
        else:
            js = jnew
        pl, ps = pm.decode_step(pp, torch.tensor(tok), ps,
                                commit=None if commit is None
                                else torch.tensor(commit))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGITS)
        _assert_trees(bridge.lm_states_to_numpy(ps), _np(js),
                      f"states after step {step}", **ACT)
        # a row that does not commit decodes its token again
        rows = np.ones(2, bool) if commit is None else np.asarray(commit)
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        assert np.array_equal(nxt[rows], pl.numpy().argmax(-1)[rows])
        tok = np.where(rows[:, None], nxt[:, None], tok)


def _merge(old, new, mask):
    """The reference engine's masked merge: ``new`` in the ``mask`` rows
    (axis 0 of ``pos``, axis 1 of the stacked segment leaves)."""
    paths = []
    j_pytree.tree_map_with_path_str(lambda p, x: paths.append(p), old)
    flat_old, tdef = jax.tree_util.tree_flatten(old)
    flat_new = jax.tree_util.tree_leaves(new)
    m = jnp.asarray(mask)

    def one(path, o, n):
        lead = 0 if path == "pos" else 1
        return jnp.where(m.reshape((1,) * lead + (-1,)
                                   + (1,) * (o.ndim - lead - 1)), n, o)

    return jax.tree_util.tree_unflatten(
        tdef, [one(p, o, n) for p, o, n in zip(paths, flat_old, flat_new)])


def test_chunked_prefill_matches_reference(ref):
    """The serving engine's continuation path: 40 tokens in chunks of 8
    (the meta tokens in front of the first), then decode; the window of
    64 is passed by the 8 + 40 + 3 tokens only in decode, where the two
    packages' rings agree."""
    _, jp = ref
    jm = _j_model()
    pm, pp = _port(ref)
    toks = _tokens(5, (1, 40))
    js, ps = jm.init_states(1, 96), pm.init_states(1, 96)
    jpre = {first: jax.jit(lambda p, b, s, f=first: jm.prefill(
        p, b, s, chunked=True, include_prefix=f)) for first in (True, False)}
    for c0 in range(0, 40, 8):
        chunk = toks[:, c0:c0 + 8]
        jl, js = jpre[c0 == 0](jp, {"tokens": jnp.asarray(chunk)}, js)
        pl, ps = pm.prefill(pp, {"tokens": torch.tensor(chunk)}, ps,
                            chunked=True, include_prefix=c0 == 0)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGITS)
    decode = jax.jit(jm.decode_step)
    for _ in range(3):
        tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        jl, js = decode(jp, jnp.asarray(tok), js)
        pl, ps = pm.decode_step(pp, torch.tensor(tok), ps)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGITS)
    _assert_trees(bridge.lm_states_to_numpy(ps), _np(js), "states", **ACT)


def test_engine_matches_reference_engine(ref):
    """tests/test_serving.py's hymba case: prompts of 5, 9, 17 and 3
    tokens, 3 slots, max_len 64, chunks of 8, 6 new tokens each — the
    same tokens, waves and iterations as the reference's engine."""
    jm, jp = ref
    pm, pp = _port(ref)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 512, size=n).astype(np.int32)
               for n in (5, 9, 17, 3)]
    je = JEngine(jm, jp, n_slots=3, max_len=64, prefill_chunk=8)
    pe = ServingEngine(pm, pp, n_slots=3, max_len=64, prefill_chunk=8,
                       device=CPU)
    for i, p in enumerate(prompts):
        je.submit(JRequest(rid=i, prompt=p, max_new_tokens=6))
        pe.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    jd, pd = je.run(), pe.run()
    assert [r.rid for r in pd] == [r.rid for r in jd]
    assert [r.out_tokens for r in pd] == [r.out_tokens for r in jd]
    assert pe.wave_sizes == je.wave_sizes
    assert pe.iterations == je.iterations


def _sequential(pm, pp, prompt, max_new, max_len):
    st = pm.init_states(1, max_len)
    lg, st = pm.prefill(pp, {"tokens": torch.tensor(prompt)[None]}, st)
    toks = [int(lg[0].argmax())]
    for _ in range(max_new - 1):
        lg, st = pm.decode_step(pp, torch.tensor([[toks[-1]]],
                                                 dtype=torch.int32), st)
        toks.append(int(lg[0].argmax()))
    return toks


def test_engine_past_the_window_matches_one_shot_prefill():
    """Past the window a prefill chunk still sees the keys that its ring
    write overwrites: the port attends before it writes, the reference
    after. Three layers (two window-64 layers, then a global one, so that
    what the window layers compute for every position reaches the
    logits), port weights from seed 0, a prompt of 120 tokens (+ 8 meta)
    in chunks of 16, rings of the reference's sizes: the port's chunked
    prefill agrees with its one-shot prefill within the model tolerance,
    and the reference's, on the same weights, is off by more than 1e-3
    (the known departure of the port's engine from the reference's past
    the window). The engine's tokens equal one-shot prefill and decode."""
    changes = dict(n_layers=3, global_layers=(2,))
    pm = build_model(ARCHS[ARCH].reduced().replace(**changes), CPU)
    pp = pm.init(0, device=CPU)
    jm = _j_model(**changes)
    jp = jax.tree_util.tree_map(jnp.asarray, bridge.lm_params_to_numpy(pp))
    toks = _tokens(6, (1, 120))
    one, _ = pm.prefill(pp, {"tokens": torch.tensor(toks)},
                        pm.init_states(1, 160))
    st, js = pm.init_states(1, 160), jm.init_states(1, 160)
    assert st["segs"][0]["kv"].k.shape == js["segs"][0]["kv"].k.shape
    assert st["segs"][0]["kv"].k.shape[3] == 64
    jpre = {first: jax.jit(lambda p, b, s, f=first: jm.prefill(
        p, b, s, chunked=True, include_prefix=f)) for first in (True, False)}
    for c0 in range(0, 120, 16):
        chunk = toks[:, c0:c0 + 16]
        lg, st = pm.prefill(pp, {"tokens": torch.tensor(chunk)}, st,
                            chunked=True, include_prefix=c0 == 0)
        jl, js = jpre[c0 == 0](jp, {"tokens": jnp.asarray(chunk)}, js)
    err = float((lg - one).abs().max())
    ref_err = float(np.abs(np.asarray(jl) - one.numpy()).max())
    assert err < 1e-4 and ref_err > 1e-3, (err, ref_err)

    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, 512, size=n).astype(np.int32)
               for n in (70, 120, 9, 97)]
    seq = [_sequential(pm, pp, p, 5, 160) for p in prompts]
    eng = ServingEngine(pm, pp, n_slots=2, max_len=160, prefill_chunk=16,
                        device=CPU)
    assert eng.states["segs"][0]["kv"].k.shape[3] == 64
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=5))
    done = sorted(eng.run(), key=lambda r: r.rid)
    assert [r.out_tokens for r in done] == seq


def test_train_step_matches_reference(ref):
    """One AdamW step (peak lr 1e-3, "chunked"): loss, grad norm and the
    parameters after it."""
    from repro.train import data as j_data

    jm = _j_model(attn_impl="chunked")
    hp = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    state = j_step.init_train_state(jm, jax.random.key(0))
    batch = j_data.SyntheticLMStream(j_data.DataConfig(
        vocab=512, seq_len=32, global_batch=2)).batch_at(0)
    want, want_m = jax.jit(j_step.make_train_step(
        jm, j_step.TrainHParams(**hp)))(state, batch)
    pm = build_model(ARCHS[ARCH].reduced().replace(attn_impl="chunked"), CPU)
    pstate = bridge.train_state_from_numpy(pm, _np(state))
    pstate, metrics = make_train_step(pm, TrainHParams(**hp))(
        pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[k]), float(want_m[k]),
                                   err_msg=k, **GRAD)
    got = bridge.train_state_to_numpy(pstate)
    _assert_trees(got["params"], _np(want.params), "params", **PARAMS_TOL)


def test_serve_and_train_launchers_on_cpu(capsys, tmp_path):
    from repro_torch.launch import serve, train

    finished = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--requests", "3", "--max-new", "4",
                           "--max-len", "48", "--prefill-chunk", "8"])
    assert len(finished) == 3
    assert "3 requests, 12 tokens" in capsys.readouterr().out
    report = train.main(["--arch", "qwen3-moe-235b-a22b", "--reduced",
                         "--device", "cpu", "--steps", "2", "--batch", "2",
                         "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert report.steps_run == 2
    assert {"load_balance_loss", "router_z_loss", "overflow_fraction"} <= \
        set(report.final_metrics)
    with pytest.raises(SystemExit, match="src_embeds"):
        serve.main(["--arch", "seamless-m4t-medium", "--reduced",
                    "--device", "cpu"])

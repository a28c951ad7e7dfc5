"""The port's LM path against the JAX package's, on the CPU.

Inputs are made with numpy from a seed; weights come from the reference's
``Model.init`` and are carried across by ``bridge.lm_params_from_numpy``.
Sizes are the reduced configs (2 layers, d_model 128, vocab 512, float32).

Tolerances, and why:
  * flash, float32: the port's plain ``attention_ref`` (what the CUDA
    kernel is held to on the card) against the reference's Pallas kernel
    in interpret mode, ``atol=2e-5, rtol=1e-4`` — the reference's own
    ``test_flash_sweep`` tolerance (online against one-pass softmax);
    bfloat16 ``atol=0.05`` — its ``test_flash_bf16``;
  * layers, attention and the ring cache, float32: ``atol=1e-5,
    rtol=1e-5`` — the two frameworks call different CPU GEMM libraries and
    sum in other orders; integer cache fields (``length``, ``kpos``) are
    compared exactly;
  * model logits after prefill and decode: ``atol=1e-4, rtol=1e-4`` (two
    layers of those differences, through the vocabulary projection);
    greedy tokens equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.kernels.flash.ops import flash_attention as j_flash  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels.flash import flash as flash_kernel  # noqa: E402
from repro_torch.kernels.flash.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash.ref import attention_ref  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402

CPU = "cpu"
ACT = dict(atol=1e-5, rtol=1e-5)
LOGITS = dict(atol=1e-4, rtol=1e-4)
DENSE = ["smollm-360m", "h2o-danube-3-4b", "qwen1.5-32b"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch, **overrides):
    """(reference model, its params, port model, the same params)."""
    cfg = J_ARCHS[arch].reduced().replace(**overrides)
    jm = j_build(cfg)
    jp = jm.init(jax.random.key(0))
    pm = build_model(ARCHS[arch].reduced().replace(**overrides), CPU)
    return jm, jp, pm, bridge.lm_params_from_numpy(pm, _np(jp))


# ------------------------------------------------------------------ flash
FLASH_SHAPES = [  # b, h, hkv, t, s, d, causal, window
    (2, 4, 2, 128, 128, 64, True, None),      # test_flash_sweep's five
    (1, 8, 2, 128, 256, 64, True, None),
    (2, 4, 2, 256, 256, 64, True, 128),
    (1, 2, 1, 128, 128, 128, False, None),
    (1, 4, 4, 256, 256, 32, True, 64),
    (1, 6, 2, 128, 128, 64, True, None),      # GQA group 3
    (1, 2, 1, 128, 128, 120, True, None),     # D = 120 (danube)
    (1, 4, 2, 64, 256, 32, True, None),       # S > T
    (1, 4, 2, 128, 256, 64, True, 48),        # S > T and a window
]


def _qkv(b, h, hkv, t, s, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, t, d).astype(np.float32) * 0.3,
            rng.randn(b, hkv, s, d).astype(np.float32) * 0.3,
            rng.randn(b, hkv, s, d).astype(np.float32) * 0.3)


@pytest.mark.parametrize("b,h,hkv,t,s,d,causal,window", FLASH_SHAPES)
def test_flash_plain_matches_reference_kernel(b, h, hkv, t, s, d, causal,
                                              window):
    q, k, v = _qkv(b, h, hkv, t, s, d)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window))
    args = [torch.tensor(x) for x in (q, k, v)]
    launches = flash_kernel.launches
    got = attention_ref(*args, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)
    # the public wrapper takes the plain version for CPU tensors
    via_ops = flash_attention(*args, causal=causal, window=window)
    assert torch.equal(via_ops, got)
    assert flash_kernel.launches == launches


def test_flash_plain_bf16_matches_reference_kernel():
    q, k, v = _qkv(1, 4, 2, 128, 128, 64, seed=1)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(j_flash(jq, jk, jv, causal=True), np.float32)
    pq, pk, pv = (torch.tensor(np.asarray(x.astype(jnp.float32))).to(
        torch.bfloat16) for x in (jq, jk, jv))
    got = attention_ref(pq, pk, pv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.05)


def test_flash_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's binding launches or raises: a CPU tensor is refused,
    never computed another way."""
    q, k, v = (torch.tensor(x)[0] for x in _qkv(1, 2, 1, 8, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel.flash_attention_cuda(
            q, k, v, n_q_heads=2, n_kv_heads=1, causal=True, window=None,
            scale=0.25)


ATTN_CASES = [  # b, h, hkv, t, s, d, causal, window
    (2, 4, 2, 64, 64, 32, True, None),
    (1, 6, 2, 40, 40, 16, True, None),
    (2, 4, 2, 96, 96, 32, True, 24),
    (1, 4, 1, 24, 56, 32, True, None),
    (1, 4, 4, 48, 48, 32, False, None),
]


@pytest.mark.parametrize("impl", ["ref", "chunked", "pallas"])
@pytest.mark.parametrize("b,h,hkv,t,s,d,causal,window", ATTN_CASES)
def test_attention_inner_matches_reference(impl, b, h, hkv, t, s, d, causal,
                                           window):
    q, k, v = _qkv(b, h, hkv, t, s, d, seed=2)
    if impl == "pallas" and (t % min(128, t) or s % min(128, s)):
        # the reference's Pallas kernel takes T, S <= 128 or multiples of
        # 128 (flash.py:115): hold the port against the reference's plain
        # version there
        want = JA.attention_inner(*map(jnp.asarray, (q, k, v)),
                                  causal=causal, window=window, impl="ref")
    else:
        want = JA.attention_inner(*map(jnp.asarray, (q, k, v)),
                                  causal=causal, window=window, impl=impl,
                                  chunk=16)
    got = PA.attention_inner(*map(torch.tensor, (q, k, v)), causal=causal,
                             window=window, impl=impl, chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)
    if impl == "chunked" and h != hkv:
        expanded = PA.attention_inner(*map(torch.tensor, (q, k, v)),
                                      causal=causal, window=window,
                                      impl=impl, chunk=16, gqa_expand=True)
        np.testing.assert_allclose(expanded.numpy(), got.numpy(), **ACT)


# ----------------------------------------------------------------- layers
def test_layers_match_reference():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 7, 4, 32).astype(np.float32)
    pos = rng.randint(0, 500, size=(2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        PL.rope(torch.tensor(x), torch.tensor(pos), 10_000.0).numpy(),
        np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)),
        **ACT)
    h = rng.randn(3, 5, 64).astype(np.float32)
    scale = rng.rand(64).astype(np.float32) + 0.5
    np.testing.assert_allclose(
        PL.rmsnorm(PL.RMSNorm(torch.tensor(scale)), torch.tensor(h),
                   1e-5).numpy(),
        np.asarray(JL.rmsnorm({"scale": jnp.asarray(scale)},
                              jnp.asarray(h), 1e-5)), **ACT)
    ws = [rng.randn(*sh).astype(np.float32) * 0.1
          for sh in ((64, 96), (64, 96), (96, 64))]
    jp = {n: {"w": jnp.asarray(w)}
          for n, w in zip(("w_gate", "w_up", "w_out"), ws)}
    pp = PL.SwiGLU(*(PL.Dense(torch.tensor(w)) for w in ws))
    np.testing.assert_allclose(PL.swiglu(pp, torch.tensor(h)).numpy(),
                               np.asarray(JL.swiglu(jp, jnp.asarray(h))),
                               **ACT)
    b = rng.randn(96).astype(np.float32)
    np.testing.assert_allclose(
        PL.dense(PL.Dense(torch.tensor(ws[0]), torch.tensor(b)),
                 torch.tensor(h)).numpy(),
        np.asarray(JL.dense({"w": jnp.asarray(ws[0]), "b": jnp.asarray(b)},
                            jnp.asarray(h))), **ACT)
    logits = rng.randn(4, 6, 50).astype(np.float32)
    labels = rng.randint(0, 50, size=(4, 6)).astype(np.int32)
    labels[0, :3] = -100
    np.testing.assert_allclose(
        float(PL.cross_entropy(torch.tensor(logits), torch.tensor(labels),
                               z_loss=1e-3)),
        float(JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                               z_loss=1e-3)), **ACT)


# -------------------------------------------------- attention and the ring
def _layer0(jp, pp):
    jlp = jax.tree_util.tree_map(lambda a: a[0], jp["segments"][0])
    return jlp["attn"], pp.segments[0][0].attn


def _assert_cache(pc, jc):
    np.testing.assert_allclose(pc.k.float().numpy(),
                               np.asarray(jc.k, np.float32), **ACT)
    np.testing.assert_allclose(pc.v.float().numpy(),
                               np.asarray(jc.v, np.float32), **ACT)
    np.testing.assert_array_equal(pc.length.numpy(), np.asarray(jc.length))
    np.testing.assert_array_equal(pc.kpos.numpy(), np.asarray(jc.kpos))


def _cache_from(jc):
    return PA.KVCache(*(bridge._tensor(np.asarray(x), CPU) for x in jc))


def _merged(new, old, commit):
    """The reference engine's masked merge of two caches: ``new`` in the
    ``commit`` rows."""
    if commit is None:
        return new
    m = jnp.asarray(commit)
    return JA.KVCache(*(jnp.where(m.reshape((-1,) + (1,) * (n.ndim - 1)),
                                  n, o) for n, o in zip(new, old)))


@pytest.mark.parametrize("arch", DENSE)
def test_attention_modes_and_ring_match_reference(arch):
    """train, one-shot prefill (danube's ring of 64 wraps under an
    80-token prompt), decode, a decode that commits one row only (the
    reference's masked merge; the idle row's output too), and a chunk
    step, cache compared after each. The reference also runs on a ring of
    4 more slots: its decode gives the same outputs there, and its chunk
    step gives the port's output, which attends before it writes the
    ring; in danube's ring of 64 the reference's own chunk step has
    overwritten keys its first queries still see."""
    jm, jp, pm, pp = _pair(arch, attn_impl="chunked")
    cfg, pcfg = jm.cfg, pm.cfg
    ja, pa = _layer0(jp, pp)
    window = cfg.sliding_window
    rng = np.random.RandomState(4)
    b, t = 2, 80
    x = rng.randn(b, t, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t))

    # train (no cache)
    jo, _ = JA.attention(ja, jnp.asarray(x), cfg, positions=jnp.asarray(pos),
                         window=window)
    po = PA.attention(pa, torch.tensor(x), pcfg, positions=torch.tensor(pos),
                      window=window)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), **ACT)

    smax = min(96, window) if window else 96
    jc, jw = (JA.init_kv_cache(b, cfg.n_kv_heads, n, cfg.hd, jnp.float32)
              for n in (smax, smax + 4))
    pc = _cache_from(jc)
    jo, jc = JA.attention(ja, jnp.asarray(x), cfg, positions=jnp.asarray(pos),
                          window=window, cache=jc, mode="prefill")
    _, jw = JA.attention(ja, jnp.asarray(x), cfg, positions=jnp.asarray(pos),
                         window=window, cache=jw, mode="prefill")
    po = PA.attention(pa, torch.tensor(x), pcfg, positions=torch.tensor(pos),
                      window=window, cache=pc, mode="prefill")
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), **ACT)
    _assert_cache(pc, jc)

    for step, commit in enumerate([None, None, [True, False], None]):
        xd = rng.randn(b, 1, cfg.d_model).astype(np.float32)
        dpos = np.asarray(jc.length)[:, None]
        jo, jnew = JA.attention(ja, jnp.asarray(xd), cfg,
                                positions=jnp.asarray(dpos), window=window,
                                cache=jc, mode="decode")
        jwo, jwnew = JA.attention(ja, jnp.asarray(xd), cfg,
                                  positions=jnp.asarray(dpos), window=window,
                                  cache=jw, mode="decode")
        np.testing.assert_allclose(np.asarray(jwo), np.asarray(jo), **ACT)
        jc, jw = _merged(jnew, jc, commit), _merged(jwnew, jw, commit)
        po = PA.attention(pa, torch.tensor(xd), pcfg,
                          positions=torch.tensor(dpos), window=window,
                          cache=pc, mode="decode",
                          commit=None if commit is None
                          else torch.tensor(commit))
        np.testing.assert_allclose(po.numpy(), np.asarray(jo), **ACT)
        _assert_cache(pc, jc)

    xc = rng.randn(b, 5, cfg.d_model).astype(np.float32)
    cpos = np.asarray(jc.length)[:, None] + np.arange(5, dtype=np.int32)
    _, jc = JA.attention(ja, jnp.asarray(xc), cfg,
                         positions=jnp.asarray(cpos), window=window,
                         cache=jc, mode="chunk")
    jo, _ = JA.attention(ja, jnp.asarray(xc), cfg,
                         positions=jnp.asarray(cpos), window=window,
                         cache=jw, mode="chunk")
    po = PA.attention(pa, torch.tensor(xc), pcfg,
                      positions=torch.tensor(cpos), window=window, cache=pc,
                      mode="chunk")
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), **ACT)
    _assert_cache(pc, jc)


def test_float8_cache_matches_reference():
    """kv_cache_dtype float8_e4m3fn: the same bytes in the ring."""
    jm, jp, pm, pp = _pair("smollm-360m", kv_cache_dtype="float8_e4m3fn")
    rng = np.random.RandomState(5)
    toks = rng.randint(0, jm.cfg.vocab, size=(1, 12)).astype(np.int32)
    js = jm.init_states(1, 32)
    jl, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, js)
    ps = pm.init_states(1, 32)
    pl_, ps = pm.prefill(pp, {"tokens": torch.tensor(toks)}, ps)
    jkv, pkv = js["segs"][0]["kv"], ps["segs"][0]["kv"]
    assert pkv.k.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(
        pkv.k.view(torch.uint8).numpy(),
        np.asarray(jkv.k).view(np.uint8))
    np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **LOGITS)


# ------------------------------------------------------------------ model
def _greedy(logits):
    return np.asarray(logits).argmax(-1).astype(np.int32)


@pytest.mark.parametrize("impl", ["ref", "chunked", "pallas"])
@pytest.mark.parametrize("arch", DENSE)
def test_model_prefill_and_decode_match_reference(arch, impl):
    jm, jp, pm, pp = _pair(arch, attn_impl=impl)
    rng = np.random.RandomState(6)
    toks = rng.randint(0, jm.cfg.vocab, size=(2, 80)).astype(np.int32)
    js = jm.init_states(2, 96)
    jl, js = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)}, js)
    ps = pm.init_states(2, 96)
    pl_, ps = pm.prefill(pp, {"tokens": torch.tensor(toks)}, ps)
    np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **LOGITS)
    decode = jax.jit(jm.decode_step)
    for _ in range(6):
        tok = _greedy(jl)
        assert np.array_equal(tok, _greedy(pl_.numpy()))
        jl, js = decode(jp, jnp.asarray(tok[:, None]), js)
        pl_, ps = pm.decode_step(pp, torch.tensor(tok[:, None]), ps)
        np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **LOGITS)
    want = _np(js)
    got = bridge.lm_states_to_numpy(ps)
    np.testing.assert_array_equal(got["pos"], want["pos"])
    _assert_cache(_cache_from(got["segs"][0]["kv"].values()),
                  want["segs"][0]["kv"])


def _wide_rings(jm, batch, max_len, extra):
    """The reference's empty states with ``extra`` more slots in every
    sliding-window ring: rings that a chunk of up to ``extra + 1`` tokens
    does not wrap onto keys its queries still see."""
    st = jm.init_states(batch, max_len)
    cfg = jm.cfg
    if cfg.sliding_window is None or cfg.sliding_window >= max_len:
        return st
    n_layers = st["segs"][0]["kv"].k.shape[0]
    one = JA.init_kv_cache(batch, cfg.n_kv_heads, cfg.sliding_window + extra,
                           cfg.hd, st["segs"][0]["kv"].k.dtype)
    st["segs"][0]["kv"] = jax.tree_util.tree_map(
        lambda x: jnp.stack([x] * n_layers), one)
    return st


@pytest.mark.parametrize("arch", DENSE)
def test_model_chunked_prefill_matches_reference(arch):
    """The serving engine's continuation path: a prompt in chunks of 16
    against the growing cache, then decode. The reference runs on rings
    of window + 15 slots: in danube's ring of 64 its chunk over positions
    64-69 writes before it attends and loses keys 1-5, which the port's
    chunk, attending before it writes, keeps."""
    jm, jp, pm, pp = _pair(arch)
    rng = np.random.RandomState(7)
    toks = rng.randint(0, jm.cfg.vocab, size=(1, 70)).astype(np.int32)
    js, ps = _wide_rings(jm, 1, 96, 15), pm.init_states(1, 96)
    for c0 in range(0, 70, 16):
        chunk = toks[:, c0:c0 + 16]
        jl, js = jm.prefill(jp, {"tokens": jnp.asarray(chunk)}, js,
                            chunked=True, include_prefix=c0 == 0)
        pl_, ps = pm.prefill(pp, {"tokens": torch.tensor(chunk)}, ps,
                             chunked=True, include_prefix=c0 == 0)
        np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **LOGITS)
    for _ in range(3):
        tok = _greedy(jl)[:, None]
        jl, js = jm.decode_step(jp, jnp.asarray(tok), js)
        pl_, ps = pm.decode_step(pp, torch.tensor(tok), ps)
        np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **LOGITS)
    np.testing.assert_array_equal(ps["pos"].numpy(), np.asarray(js["pos"]))


def test_states_round_trip_through_bridge():
    jm, jp, pm, pp = _pair("h2o-danube-3-4b")
    toks = np.arange(70, dtype=np.int32)[None] % jm.cfg.vocab
    _, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                       jm.init_states(1, 96))
    ps = bridge.lm_states_from_numpy(_np(js), CPU)
    back = bridge.lm_states_to_numpy(ps)
    for name in ("k", "v", "length", "kpos"):
        np.testing.assert_array_equal(
            back["segs"][0]["kv"][name],
            np.asarray(getattr(js["segs"][0]["kv"], name)))
    # the port continues from the reference's states as the reference does
    tok = jnp.asarray([[5]], jnp.int32)
    jl, _ = jm.decode_step(jp, tok, js)
    pl_, _ = pm.decode_step(pp, torch.tensor([[5]], dtype=torch.int32), ps)
    np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **LOGITS)


def test_apply_train_and_loss_match_reference():
    jm, jp, pm, pp = _pair("qwen1.5-32b", attn_impl="chunked")
    rng = np.random.RandomState(8)
    batch = {"tokens": rng.randint(0, 512, size=(2, 32)).astype(np.int32),
             "labels": rng.randint(0, 512, size=(2, 32)).astype(np.int32)}
    jlog, _ = jm.apply_train(jp, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    plog, _ = pm.apply_train(pp, {k: torch.tensor(v) for k, v in
                                  batch.items()})
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **LOGITS)
    jloss, _ = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    ploss, metrics = pm.loss(pp, {k: torch.tensor(v) for k, v in
                                  batch.items()})
    np.testing.assert_allclose(float(ploss), float(jloss), **ACT)
    assert set(metrics) == {"ce"}


def test_param_tree_matches_reference_paths():
    """Every leaf of the reference's tree is one parameter of the port
    (stacked leaves per layer), with its shape — for all dense configs'
    reduced sizes, tied and untied embeddings."""
    for arch in DENSE:
        jm, jp, pm, pp = _pair(arch)
        names = dict(pp.named_parameters())
        n = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jp))
        assert sum(p.numel() for p in names.values()) == n
        assert ("lm_head.w" in names) == (not jm.cfg.tie_embeddings)
        assert "segments.0.1.attn.wq.w" in names
        assert ("segments.0.0.attn.wq.b" in names) == jm.cfg.qkv_bias
        # Model.init draws the same tree (other numbers)
        fresh = dict(pm.init(1, device=CPU).named_parameters())
        assert {k: v.shape for k, v in fresh.items()} == \
            {k: v.shape for k, v in names.items()}


@pytest.mark.parametrize("knob", [dict(moe_impl="shard_map"),
                                  dict(tp_shard_map=True),
                                  dict(seq_parallel=True)],
                         ids=["moe_impl", "tp_shard_map", "seq_parallel"])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "smollm-360m"])
def test_mesh_only_knobs_run_the_plain_path(arch, knob):
    """The reference's mesh-only knobs: without a mesh it runs its plain
    path under each (``moe_layer``, the plain attention block, no
    sequence constraint), and so does the port, which has no mesh yet —
    the logits of a 32-token batch equal the reference's (train, and a
    prefill of 16 tokens)."""
    jm, jp, pm, pp = _pair(arch, attn_impl="chunked", **knob)
    toks = np.random.RandomState(9).randint(0, 512, size=(2, 32)).astype(
        np.int32)
    jl, _ = jax.jit(jm.apply_train)(jp, {"tokens": jnp.asarray(toks)})
    pl_, _ = pm.apply_train(pp, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **LOGITS)
    jl, _ = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :16])},
                                jm.init_states(2, 32))
    pl_, _ = pm.prefill(pp, {"tokens": torch.tensor(toks[:, :16])},
                        pm.init_states(2, 32))
    np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **LOGITS)

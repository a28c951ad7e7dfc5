"""The port's training path against the JAX package's, on the CPU.

Reduced smollm-360m (dense) and rwkv6-3b (RWKV6) — 2 layers, d_model 128,
vocab 512, float32 — each through ``attn_impl`` "ref" and "chunked".
Parameters come from the reference's ``init_train_state`` and are carried
across by ``bridge.train_state_from_numpy``; batches from the reference's
``SyntheticLMStream`` (4 × 32 tokens). Each case's reference runs (one
``jax.value_and_grad`` of ``model.loss``, three jitted train steps at
``microbatches`` 1 and 2) are made once in a module fixture.

Tolerances, and why:
  * loss and every gradient leaf: ``rtol=1e-5, atol=1e-6`` (gradients up
    to ~1, float32 sums in another order);
  * three train steps (``peak_lr`` 1e-3, AdamW's defaults) after each
    step: ``mu``, ``nu`` and the metrics ``loss``, ``ce``, ``grad_norm``,
    ``lr`` within ``rtol=1e-5, atol=1e-6``; ``count`` and ``step``
    exactly; params within ``rtol=1e-5, atol=2e-5`` (2 % of the peak
    ``lr``): Adam's step ``m / (sqrt(v) + eps)`` is normalized, so it
    carries a gradient's *relative* rounding into the parameter at the
    scale of ``lr`` — where a gradient is tiny (1e-7 against a largest
    of 0.08) the two packages' roundings, 2e-9 apart, are 0.5 % of it.
    Measured: up to 7.9e-6 (0.8 % of ``lr``) on 2 of rwkv6's 65,536
    embedding entries at step 3, every gradient within the tolerance
    above. Weight decay, too small to see at this scale on the
    matrices, is held by its own test;
  * schedules: ``rtol=1e-6, atol=1e-10`` (the same float32 operations;
    ``cos`` may differ in its last bit, which near the end of a schedule
    to 0 is 9e-12 on 3e-4); the data stream: exactly (the same numpy
    draws);
  * checkpoints: bit for bit; remat on against off: bit for bit (the
    same operations recomputed, one thread).
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro.train import checkpoint as j_checkpoint  # noqa: E402
from repro.train import data as j_data  # noqa: E402
from repro.train import optim as j_optim  # noqa: E402
from repro.train import schedule as j_schedule  # noqa: E402
from repro.train import step as j_step  # noqa: E402
from repro.utils import pytree as j_pytree  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels.flash.ops import flash_attention  # noqa: E402
from repro_torch.kernels.wkv6.ops import wkv6  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.train import checkpoint, data, loop, optim, schedule  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    TrainHParams,
    init_train_state,
    make_train_step,
)
from repro_torch.utils import pytree  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-6)
FAMILIES = ["smollm-360m", "rwkv6-3b"]
CASES = [(a, i) for a in FAMILIES for i in ("ref", "chunked")]
SEQ, BATCH, STEPS = 32, 4, 3
HP = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
PARAMS_TOL = dict(rtol=1e-5, atol=2e-5)     # see the module docstring


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree) -> dict:
    """'/'-joined path -> numpy leaf, for a reference pytree or the
    bridge's nested dicts."""
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
                                       **(tol or TOL))


def _stream(vocab, seq=SEQ, batch=BATCH, **kw):
    return data.SyntheticLMStream(data.DataConfig(
        vocab=vocab, seq_len=seq, global_batch=batch, **kw))


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_model(arch, impl, **changes):
    return build_model(ARCHS[arch].reduced().replace(attn_impl=impl,
                                                     **changes), CPU)


@pytest.fixture(scope="module", params=CASES, ids=[f"{a}-{i}"
                                                   for a, i in CASES])
def case(request):
    """The reference's runs for one (arch, attn_impl): the initial train
    state, loss and gradients on batch 0, and the state and metrics after
    each of three steps at microbatches 1 and 2."""
    arch, impl = request.param
    jm = j_build(J_ARCHS[arch].reduced().replace(attn_impl=impl))
    state = j_step.init_train_state(jm, jax.random.key(0))
    batches = [_stream(jm.cfg.vocab).batch_at(s) for s in range(STEPS)]
    (loss, _), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        state.params, batches[0])
    runs = {}
    for n in (1, 2):
        fn = jax.jit(j_step.make_train_step(
            jm, j_step.TrainHParams(**HP, microbatches=n)))
        s, out = state, []
        for b in batches:
            s, m = fn(s, b)
            out.append((_np(s), _np(m)))
        runs[n] = out
    return {"arch": arch, "impl": impl, "state": _np(state),
            "batches": batches, "loss": float(loss), "grads": _np(grads),
            "runs": runs}


def _port_state(case, **changes):
    model = _port_model(case["arch"], case["impl"], **changes)
    return model, bridge.train_state_from_numpy(model, case["state"])


# -------------------------------------------------------- loss and grads
def test_loss_and_grads_match_reference(case):
    model, state = _port_state(case)
    named = dict(state.params.named_parameters())
    loss, metrics = model.loss(state.params, _tensors(case["batches"][0]))
    grads = torch.autograd.grad(loss, list(named.values()))
    np.testing.assert_allclose(loss.item(), case["loss"], **TOL)
    assert metrics["ce"] is loss
    _assert_trees(bridge.lm_params_to_numpy(dict(zip(named, grads))),
                  case["grads"], "grads")


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_steps_match_reference(case, n_micro):
    model, state = _port_state(case)
    step_fn = make_train_step(model, TrainHParams(**HP,
                                                  microbatches=n_micro))
    for i, (want, want_m) in enumerate(case["runs"][n_micro]):
        state, metrics = step_fn(state, _tensors(case["batches"][i]))
        assert sorted(metrics) == sorted(want_m)
        for k, v in metrics.items():
            assert v.device.type == CPU and v.dtype == torch.float32, k
            np.testing.assert_allclose(float(v), want_m[k], err_msg=k,
                                       **TOL)
        got = bridge.train_state_to_numpy(state)
        _assert_trees(got["params"], want.params, f"step {i + 1} params",
                      **PARAMS_TOL)
        _assert_trees({k: got[k] for k in ("opt", "step")},
                      {"opt": want.opt, "step": want.step}, f"step {i + 1}")


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_on_and_off_give_equal_grads(arch):
    grads = {}
    batch = _tensors(_stream(512).batch_at(0))
    for remat in (True, False):
        model = _port_model(arch, "chunked", remat=remat)
        state = init_train_state(model, 0, device=CPU)
        loss, _ = model.loss(state.params, batch)
        grads[remat] = torch.autograd.grad(loss, list(
            state.params.parameters()))
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b)


def test_remat_keeps_only_layer_inputs(monkeypatch):
    """With remat each layer runs again in the backward pass (the
    reference's ``jax.checkpoint``); without it, once."""
    from repro_torch.models import transformer

    calls = []
    inner = transformer.apply_layer

    def counted(*args, **kwargs):
        calls.append(args[0])
        return inner(*args, **kwargs)

    monkeypatch.setattr(transformer, "apply_layer", counted)
    batch = _tensors(_stream(512).batch_at(0))
    for remat, want in ((True, 4), (False, 2)):
        calls.clear()
        model = _port_model("smollm-360m", "chunked", remat=remat)
        state = init_train_state(model, 0, device=CPU)
        loss, _ = model.loss(state.params, batch)
        torch.autograd.grad(loss, list(state.params.parameters()))
        assert len(calls) == want, (remat, calls)
    calls.clear()
    with torch.no_grad():                     # no grad: no checkpoint
        model.loss(state.params, batch)
    assert len(calls) == 2


# ------------------------------------------------------------- optimizer
@pytest.mark.parametrize("arch", FAMILIES)
def test_weight_decay_follows_the_reference_rank(arch):
    """Zero gradients: each leaf moves by lr · wd · p alone, where the
    reference's stacked leaf has rank >= 2 — every per-layer vector —
    and not at all for final_norm.scale."""
    jm = j_build(J_ARCHS[arch].reduced())
    jp = jm.init(jax.random.key(1))
    cfg = optim.AdamWConfig()
    lr = 0.5
    zeros = jax.tree_util.tree_map(jnp.zeros_like, jp)
    want, _, _ = j_optim.adamw_update(j_optim.AdamWConfig(), jp, zeros,
                                      j_optim.adamw_init(jp), lr)
    model = _port_model(arch, "ref")
    params = bridge.lm_params_from_numpy(model, _np(jp))
    before = {k: p.clone() for k, p in params.named_parameters()}
    grads = {k: torch.zeros_like(p) for k, p in before.items()}
    params, state, metrics = optim.adamw_update(
        cfg, params, grads, optim.adamw_init(params), lr)
    assert float(metrics["grad_norm"]) == 0.0 and int(state.count) == 1
    _assert_trees(bridge.lm_params_to_numpy(params), _np(want), "decay")
    decayed = {k for k, p in params.named_parameters()
               if not torch.equal(p, before[k])}
    assert "final_norm.scale" not in decayed
    vectors = {"norm1.scale", "norm2.scale"}
    if arch == "rwkv6-3b":
        vectors |= {f"rwkv.tm.{n}" for n in ("mu_r", "mu_k", "mu_v", "mu_w",
                                             "mu_g", "w0", "u", "ln_scale")}
        vectors.add("rwkv.cm.mu")
    for v in vectors:
        assert f"segments.0.1.{v}" in decayed, v
    assert decayed == set(before) - {"final_norm.scale"}


def test_adamw_matches_reference_on_a_dict_tree():
    """Five steps on a plain dict of tensors (clip active, decay on the
    matrix only) against the reference's ``adamw_update``."""
    cfg = dict(b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.1, grad_clip=0.5)
    rng = np.random.RandomState(0)
    p0 = {"w": rng.randn(3, 4).astype(np.float32),
          "b": rng.randn(4).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = j_optim.adamw_init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = optim.adamw_init(tp)
    for t in range(5):
        g = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in p0.items()}
        jp, js, jm = j_optim.adamw_update(
            j_optim.AdamWConfig(**cfg), jp, {k: jnp.asarray(v)
                                             for k, v in g.items()}, js,
            0.1)
        tp, ts, tm = optim.adamw_update(
            optim.AdamWConfig(**cfg), tp,
            {k: torch.from_numpy(v) for k, v in g.items()}, ts, 0.1)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), **TOL)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       **TOL)
            np.testing.assert_allclose(ts.mu[k].numpy(),
                                       np.asarray(js.mu[k]), **TOL)
            np.testing.assert_allclose(ts.nu[k].numpy(),
                                       np.asarray(js.nu[k]), **TOL)
        assert int(ts.count) == int(js.count) == t + 1


# ------------------------------------------------------------- schedules
@pytest.mark.parametrize("warmup,total", [(0, 100), (10, 100), (25, 60),
                                          (5, 5)])
def test_schedules_match_reference(warmup, total):
    steps = np.arange(0, 121)
    for name, kw in (("cosine_schedule", dict(final_frac=0.1)),
                     ("cosine_schedule", dict(final_frac=0.0)),
                     ("linear_schedule", {})):
        want = np.asarray(getattr(j_schedule, name)(
            jnp.asarray(steps), peak_lr=3e-4, warmup_steps=warmup,
            total_steps=total, **kw))
        got = getattr(schedule, name)(
            torch.from_numpy(steps).to(torch.int32), peak_lr=3e-4,
            warmup_steps=warmup, total_steps=total, **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-10,
                                   err_msg=f"{name} {kw}")
        for s in (0, warmup, total, 120):        # a Python int step
            one = getattr(schedule, name)(s, peak_lr=3e-4,
                                          warmup_steps=warmup,
                                          total_steps=total, **kw)
            assert float(one) == float(got[s])


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_stream_batches_bit_equal_to_reference(n_hosts):
    kw = dict(vocab=1000, seq_len=64, global_batch=8, seed=3)
    for host in range(n_hosts):
        got = data.SyntheticLMStream(data.DataConfig(**kw), host_id=host,
                                     n_hosts=n_hosts)
        want = j_data.SyntheticLMStream(j_data.DataConfig(**kw),
                                        host_id=host, n_hosts=n_hosts)
        for step in (0, 1, 7, 1000):
            a, b = got.batch_at(step), want.batch_at(step)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="split"):
        data.SyntheticLMStream(data.DataConfig(**kw), n_hosts=3)


def test_prefetcher_orders_batches():
    stream = _stream(100, seq=8, batch=2)
    pf = data.Prefetcher(stream, start_step=5)
    try:
        got = [pf.next() for _ in range(4)]
    finally:
        pf.close()
    assert [s for s, _ in got] == [5, 6, 7, 8]
    np.testing.assert_array_equal(got[2][1]["tokens"],
                                  stream.batch_at(7)["tokens"])
    assert not pf._thread.is_alive()


# ------------------------------------------------------------ checkpoints
def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_same_bits(a, b):
    la, lb = dict(pytree.named_leaves(a)), dict(pytree.named_leaves(b))
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert torch.equal(_bits(la[k]), _bits(lb[k])), k


def _trained(arch, n=1, dtype="float32"):
    """A port train state after n steps (non-zero moments, count, step)."""
    model = _port_model(arch, "chunked", param_dtype=dtype)
    state = init_train_state(model, 0, device=CPU)
    step_fn = make_train_step(model, TrainHParams(**HP))
    for s in range(n):
        state, _ = step_fn(state, _tensors(_stream(512).batch_at(s)))
    return model, state


@pytest.mark.parametrize("arch", FAMILIES)
def test_float32_checkpoints_restore_both_ways(arch, tmp_path):
    model, state = _trained(arch)
    jm = j_build(J_ARCHS[arch].reduced())
    like = j_step.init_train_state(jm, jax.random.key(5))

    # the port writes, the reference restores
    checkpoint.CheckpointManager(str(tmp_path / "p")).save(
        1, state, blocking=True)
    restored, step = j_checkpoint.CheckpointManager(
        str(tmp_path / "p")).restore(like)
    assert step == 1
    _assert_trees(_np(restored), bridge.train_state_to_numpy(state),
                  "reference restore", rtol=0, atol=0)

    # the reference writes (its own state after a step), the port restores
    js, _ = jax.jit(j_step.make_train_step(jm, j_step.TrainHParams(**HP)))(
        like, _stream(512).batch_at(0))
    j_checkpoint.CheckpointManager(str(tmp_path / "j")).save(
        1, js, blocking=True)
    _, port_like = _trained(arch, n=0)
    got, step = checkpoint.CheckpointManager(str(tmp_path / "j")).restore(
        port_like)
    assert step == 1 and got is port_like
    _assert_trees(bridge.train_state_to_numpy(got), _np(js),
                  "port restore", rtol=0, atol=0)
    assert all(p.requires_grad for p in got.params.parameters())


def test_bf16_checkpoints_restore_in_the_port(tmp_path):
    """The reference's bf16 checkpoint (``|V2`` leaves, manifest dtype
    bfloat16) restores in the port bit for bit, and so does the port's
    own; both write the same records."""
    import ml_dtypes

    arch = "smollm-360m"
    jm = j_build(J_ARCHS[arch].reduced().replace(param_dtype="bfloat16"))
    js = j_step.init_train_state(jm, jax.random.key(2))
    j_checkpoint.CheckpointManager(str(tmp_path / "j")).save(
        4, js, blocking=True)
    with np.load(tmp_path / "j" / "step_00000004" / "shard_0.npz") as f:
        assert f["params|embed|table"].dtype == checkpoint.BF16_RECORD

    model, port_like = _trained(arch, n=0, dtype="bfloat16")
    got, step = checkpoint.CheckpointManager(str(tmp_path / "j")).restore(
        port_like)
    assert step == 4
    want = _leaves(_np(js))
    for p, leaf in pytree.reference_leaves(got).items():
        t = torch.stack(leaf) if isinstance(leaf, list) else leaf
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(),
                want[p].view(ml_dtypes.bfloat16).view(np.int16), err_msg=p)
        else:
            np.testing.assert_array_equal(t.numpy(), want[p], err_msg=p)

    # the port's own bf16 round trip, and the same on-disk records
    _, state = _trained(arch, n=1, dtype="bfloat16")
    mgr = checkpoint.CheckpointManager(str(tmp_path / "p"))
    mgr.save(1, state, blocking=True)
    manifest = json.loads(
        (tmp_path / "p" / "step_00000001" / "manifest.json").read_text())
    assert manifest["leaves"]["params/embed/table"] == {
        "shape": [512, 128], "dtype": "bfloat16"}
    assert manifest["leaves"]["opt/mu/embed/table"]["dtype"] == "float32"
    with np.load(tmp_path / "p" / "step_00000001" / "shard_0.npz") as f:
        assert f["params|segments|0|attn|wq|w"].dtype == \
            checkpoint.BF16_RECORD
        assert f["params|segments|0|attn|wq|w"].shape == (2, 128, 128)
    _, fresh = _trained(arch, n=0, dtype="bfloat16")
    got, _ = mgr.restore(fresh)
    _assert_same_bits(got, state)


def test_checkpoint_retention_commit_and_async(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=2)
    state = {"x": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    for s in (1, 2, 3):
        mgr.save(s, state, blocking=True)
    assert mgr.committed_steps() == [2, 3]
    os.makedirs(tmp_path / "step_00000099")                # no COMMIT
    os.makedirs(tmp_path / "step_00000098.tmp")
    (tmp_path / "step_00000098.tmp" / "COMMIT").write_text("ok")
    assert mgr.latest_step() == 3
    mgr.save(7, {"x": torch.ones(2, 3)})                  # async
    mgr.wait()
    assert mgr.latest_step() == 7
    like = {"x": torch.zeros(2, 3)}
    got, step = mgr.restore(like)
    assert step == 7 and got is like and torch.equal(like["x"],
                                                     torch.ones(2, 3))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"x": torch.zeros(3, 2)})
    with pytest.raises(FileNotFoundError):
        checkpoint.CheckpointManager(str(tmp_path / "empty")).restore(like)


def test_failed_async_write_raises_on_wait(tmp_path, monkeypatch):
    mgr = checkpoint.CheckpointManager(str(tmp_path))

    def broken(*args):
        raise OSError("disk full")

    monkeypatch.setattr(mgr, "_write", broken)
    mgr.save(1, {"x": torch.ones(2)})
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        mgr.wait()
    mgr.wait()                                            # reported once


# ------------------------------------------------------------------ loop
def test_loop_resume_equals_an_uninterrupted_run(tmp_path):
    arch = "smollm-360m"
    model = _port_model(arch, "chunked")
    step_fn = make_train_step(model, TrainHParams(**HP))
    stream = _stream(512)

    def run(total, ckpt_dir, csv_path=None):
        state = init_train_state(model, 0, device=CPU)
        return loop.train_loop(step_fn, state, stream, loop.LoopConfig(
            total_steps=total, ckpt_every=2, log_every=1,
            ckpt_dir=str(ckpt_dir), metrics_csv=csv_path))

    whole, rep = run(6, tmp_path / "whole")
    assert rep.steps_run == 6 and rep.resumed_from is None
    part, rep1 = run(3, tmp_path / "split", str(tmp_path / "m.csv"))
    assert rep1.steps_run == 3
    assert checkpoint.CheckpointManager(
        str(tmp_path / "split")).committed_steps() == [2, 3]
    resumed, rep2 = run(6, tmp_path / "split", str(tmp_path / "m.csv"))
    assert rep2.resumed_from == 3 and rep2.steps_run == 3
    assert int(resumed.step) == 6
    _assert_same_bits(resumed, whole)
    assert rep2.final_metrics == pytest.approx(rep.final_metrics, rel=0)
    rows = (tmp_path / "m.csv").read_text().strip().splitlines()
    assert [int(r.split(",")[0]) for r in rows] == [1, 2, 3, 4, 5, 6]
    last = [float(x) for x in rows[-1].split(",")]
    assert last[1:4] == [rep2.final_metrics[k]
                         for k in ("loss", "grad_norm", "lr")]


def test_mid_run_async_checkpoint_holds_its_own_step(tmp_path, monkeypatch):
    """A checkpoint written asynchronously while the loop runs on holds the
    state of its own step: restored, step 2 of a 6-step run has the bits
    of a run stopped at step 2. The write is held back so that the next
    steps update the state in place before the file is written."""
    arch = "smollm-360m"
    model = _port_model(arch, "chunked")
    step_fn = make_train_step(model, TrainHParams(**HP))
    write = checkpoint.CheckpointManager._write

    def late_write(self, *args):
        time.sleep(0.5)
        write(self, *args)

    def run(total, ckpt_dir):
        state = init_train_state(model, 0, device=CPU)
        return loop.train_loop(step_fn, state, _stream(512), loop.LoopConfig(
            total_steps=total, ckpt_every=2, ckpt_dir=str(ckpt_dir)))

    stopped, _ = run(2, tmp_path / "stopped")
    monkeypatch.setattr(checkpoint.CheckpointManager, "_write", late_write)
    run(6, tmp_path / "whole")
    mgr = checkpoint.CheckpointManager(str(tmp_path / "whole"))
    assert mgr.committed_steps() == [2, 4, 6]
    got, step = mgr.restore(init_train_state(model, 1, device=CPU), step=2)
    assert step == 2 and int(got.step) == 2
    _assert_same_bits(got, stopped)


def test_straggler_watchdog_flags_slow_steps(tmp_path):
    """A step 1 s slower than the others is flagged; the first step (the
    warm-up) does not seed the EWMA."""
    model = _port_model("smollm-360m", "chunked")
    inner = make_train_step(model, TrainHParams(total_steps=30))
    calls = {"n": 0}

    def step_fn(st, batch):  # an artificial straggler at step 12
        calls["n"] += 1
        if calls["n"] == 12:
            time.sleep(1.0)
        return inner(st, batch)

    state = init_train_state(model, 0, device=CPU)
    _, rep = loop.train_loop(step_fn, state, _stream(512, seq=16, batch=2),
                             loop.LoopConfig(total_steps=20, ckpt_every=100,
                                             ckpt_dir=str(tmp_path)))
    assert 11 in rep.straggler_steps, rep.straggler_steps


# ------------------------------------------------------ kernels refusal
@pytest.mark.parametrize("arch", FAMILIES)
def test_pallas_training_raises(arch):
    """The kernels have no backward: training through "pallas" raises,
    and nothing falls back to the plain version; without grad the same
    model runs."""
    model = _port_model(arch, "pallas")
    state = init_train_state(model, 0, device=CPU)
    batch = _tensors(_stream(512, seq=16, batch=2).batch_at(0))
    kernel = "flash_attention" if arch == "smollm-360m" else "wkv6"
    with pytest.raises(RuntimeError, match=f"{kernel} has no backward"):
        make_train_step(model, TrainHParams(**HP))(state, batch)
    assert int(state.step) == 0 and int(state.opt.count) == 0
    with torch.no_grad():
        loss, _ = model.loss(state.params, batch)
    assert torch.isfinite(loss)


def test_kernel_wrappers_refuse_grad():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 8, 16, generator=gen) for _ in range(3))
    r, kk, vv = (torch.randn(1, 2, 8, 16, generator=gen) for _ in range(3))
    w = torch.rand(1, 2, 8, 16, generator=gen)
    u = torch.randn(2, 16, generator=gen)
    for i in range(3):
        args = [x.clone() for x in (q, k, v)]
        args[i].requires_grad_(True)
        with pytest.raises(RuntimeError, match="flash_attention has no"):
            flash_attention(*args)
        with torch.no_grad():
            flash_attention(*args)
    for i in range(5):
        args = [x.clone() for x in (r, kk, vv, w, u)]
        args[i].requires_grad_(True)
        with pytest.raises(RuntimeError, match="wkv6 has no backward"):
            wkv6(*args)
        with torch.no_grad():
            wkv6(*args)
    s0 = torch.zeros(1, 2, 16, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="wkv6 has no backward"):
        wkv6(r, kk, vv, w, u, s0=s0)
    flash_attention(q, k, v)        # nothing requires grad: runs


# ---------------------------------------------------------------- pytree
def test_reference_paths_and_counts():
    jm = j_build(J_ARCHS["rwkv6-3b"].reduced())
    js = j_step.init_train_state(jm, jax.random.key(0))
    model = _port_model("rwkv6-3b", "chunked")
    state = bridge.train_state_from_numpy(model, _np(js))
    want = _leaves(_np(js))
    got = pytree.reference_leaves(state)
    assert sorted(got) == sorted(want)
    for p, leaf in got.items():
        shape = ((len(leaf),) + tuple(leaf[0].shape)
                 if isinstance(leaf, list) else tuple(leaf.shape))
        assert shape == want[p].shape, p
    assert pytree.tree_param_count(state) == j_pytree.tree_param_count(js)
    assert pytree.tree_bytes(state) == j_pytree.tree_bytes(js)
    assert pytree.tree_param_count(state.params) == \
        j_pytree.tree_param_count(js.params)
    assert pytree.reference_path("params.segments.0.1.rwkv.tm.u") == (
        "params/segments/0/rwkv/tm/u", 1)
    assert pytree.reference_path("opt.count") == ("opt/count", None)
    assert pytree.reference_ndim("segments.0.1.norm1.scale",
                                 torch.zeros(3)) == 2


# ------------------------------------------------------------------- CLI
def test_train_launcher_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "smollm-360m", "--reduced", "--device", "cpu", "--steps", "3",
           "--ckpt-dir", str(tmp_path / "ckpt"), "--metrics-csv",
           str(tmp_path / "m.csv"), "--ckpt-every", "2"]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout
    assert "[train] ran 3 steps on cpu" in out, out
    assert "resumed_from=None" in out
    assert checkpoint.CheckpointManager(
        str(tmp_path / "ckpt")).committed_steps() == [2, 3]
    again = subprocess.run(cmd + ["--steps", "4"], env=env,
                           capture_output=True, text=True, timeout=120,
                           check=True).stdout
    assert "ran 1 steps" in again and "resumed_from=3" in again, again

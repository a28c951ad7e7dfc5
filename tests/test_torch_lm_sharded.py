"""The port's sharded LM path on four ranks, against the reference.

A module fixture writes the inputs (initial train states and layer
parameters from the port's seeded initializers, the reference's batches,
as numpy), then starts at once the port on
four ``gloo`` ranks on the CPU (a (2, 2) ("data", "model") DeviceMesh,
``tests/torch_lm_sharded_cases.py``) and the reference's sharded layers
on four virtual XLA devices in a subprocess, and meanwhile runs the
reference's single-device train steps here. Each side imports only its
own package. The ranks restore the (2, 2) checkpoint of step 3 onto a
(2, 1) mesh over two of them, as the reference's test restores onto some
of its devices.

Contracts, and why:
  * the sharded train step equals the reference's single-device step:
    losses within ``rtol=2e-4``, the reference tests' own bound (SPMD is
    a performance transform, not a semantic one); so do both RWKV6
    layouts ("dp" == "tp") and the dense MoE dispatch on the mesh;
  * the expert-parallel MoE in the train step against the reference's
    single-device dense step within ``rtol=3e-3`` (the reference test's
    bound: the bfloat16 sum over model and the per-shard capacity);
  * the sharded layers against the reference's sharded layers on (2, 2):
    float32 within ``rtol=1e-5, atol=1e-5`` (the same operations, sums
    in another order) for the Megatron-SP block and the weight-gathered
    MoE; the psum branch sums ``h`` and ``u`` in bfloat16 over model,
    so a float32 rounding apart before the cast can flip one bfloat16
    rounding: its outputs and gradients within ``atol=5e-3`` (about one
    bfloat16 ulp of values up to ~2.5; measured 8.3e-7 on the outputs,
    1.6e-3 on the gradients, whose backward sums in bfloat16 too), its
    aux terms within ``rtol=1e-5`` (measured equal);
  * sharded decode equals unsharded decode within ``1e-5``; the int8
    cross-pod reduction equals the mean of the compressed gradients
    within ``1e-6``, its residuals exactly;
  * the dry run's collectives, recorded on the meta device over a fake
    process group of four ranks, equal rank 0's recorded step, op by op
    and exactly (the same step: shapes, not values, decide them).
"""
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import torch_lm_sharded_cases as C  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro.train import optim as j_optim  # noqa: E402
from repro.train import step as j_step  # noqa: E402
from repro.train.data import DataConfig, SyntheticLMStream  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 400
STEP_RTOL = 2e-4
MOE_RTOL = 3e-3
F32 = dict(rtol=1e-5, atol=1e-5)
BF16_SUM_ATOL = 5e-3


def _plain(tree):
    """A reference pytree as dicts/lists of numpy (no repro types)."""
    if hasattr(tree, "_fields"):
        return {k: _plain(getattr(tree, k)) for k in tree._fields}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return np.asarray(tree)


def _batches(key, n=4):
    cfg = C.config(J_ARCHS, key)
    stream = SyntheticLMStream(DataConfig(vocab=cfg.vocab, seq_len=C.SEQ,
                                          global_batch=C.BATCH[key]))
    return [stream.batch_at(s) for s in range(n)]


def _inputs():
    """Every input, as numpy: the initial train states and the layers'
    parameters from the port's seeded initializers (fast, so the ranks
    start at once; the reference then starts from the same values), the
    batches from the reference's stream, the layer inputs from numpy."""
    from repro_torch import bridge
    from repro_torch.configs import ARCHS
    from repro_torch.models.api import build_model
    from repro_torch.models.layers import Init
    from repro_torch.models.moe import init_moe
    from repro_torch.train.step import init_train_state

    rng = np.random.default_rng(0)
    states, batches = {}, {}
    for key in C.TRAIN:
        model = build_model(C.config(ARCHS, key), "cpu")
        states[key] = bridge.train_state_to_numpy(
            init_train_state(model, 0, device="cpu"))
        batches[key] = _batches(key)
    moe = init_moe(Init(torch.device("cpu"), torch.Generator().manual_seed(0)),
                   C.config(ARCHS, "moe"))
    moe_params = {"router": {"w": moe.router.w.numpy()},
                  "experts": {n: getattr(moe.experts, n).numpy()
                              for n in ("w_gate", "w_up", "w_out")}}
    layers = {
        "moe_params": moe_params,
        "moe_x": rng.standard_normal(C.MOE_X, dtype=np.float32),
        "moe_c": rng.standard_normal(C.MOE_X, dtype=np.float32),
        "block": {k: bridge.lm_params_to_numpy(build_model(
            C.config(ARCHS, k), "cpu").init(0, device="cpu"))
            for k in ("deepseek", "danube")},
        "block_x": rng.standard_normal(C.BLOCK_X, dtype=np.float32),
        "block_c": rng.standard_normal(C.BLOCK_X, dtype=np.float32),
        "block_batch": {
            "tokens": rng.integers(0, 512, (2, 32), dtype=np.int32),
            "labels": rng.integers(0, 512, (2, 32), dtype=np.int32)},
    }
    return {"states": states, "batches": batches, "layers": layers,
            "decode_tokens": rng.integers(
                0, 512, (4, 8 + C.DECODE_STEPS), dtype=np.int32)}


def _jax_state(tree):
    """The reference's TrainState of a numpy one (the bridge's layout)."""
    arrays = jax.tree_util.tree_map(jnp.asarray, tree)
    return j_step.TrainState(params=arrays["params"], opt=j_optim.OptState(
        **arrays["opt"]), step=arrays["step"])


def _reference_runs(inputs):
    """The reference's single-device runs from the same initial states:
    train-step losses and final states, and the block models' losses."""
    out = {}
    for key, steps in C.TRAIN.items():
        model = j_build(C.config(J_ARCHS, key))
        fn = jax.jit(j_step.make_train_step(model,
                                            j_step.TrainHParams(**C.HP)))
        state = _jax_state(inputs["states"][key])
        losses = []
        for b in inputs["batches"][key][:steps]:
            state, m = fn(state, b)
            losses.append(float(m["loss"]))
        out[key] = losses
        out[f"{key}_state"] = _plain(state)
    for key in ("deepseek", "danube"):
        model = j_build(C.config(J_ARCHS, key))
        loss, _ = jax.jit(model.loss)(
            jax.tree_util.tree_map(jnp.asarray,
                                   inputs["layers"]["block"][key]),
            {k: jnp.asarray(v)
             for k, v in inputs["layers"]["block_batch"].items()})
        out[f"block_{key}"] = float(loss)
    return out


def _join(procs, tmp, name, t0):
    for r, p in enumerate(procs):
        p.join(max(DEADLINE_S - (time.monotonic() - t0), 1))
        if p.is_alive():
            p.kill()
            pytest.fail(f"{name} rank {r} did not finish in {DEADLINE_S} s")
        if p.exitcode != 0:
            err = os.path.join(tmp, f"{name}{r}.err")
            text = open(err).read() if os.path.exists(err) else ""
            pytest.fail(f"{name} rank {r} exited {p.exitcode}:\n{text}")
    with open(os.path.join(tmp, f"{name}0.pkl"), "rb") as f:
        return pickle.load(f)


def _spawn(target, world, tmp, store):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, os.path.join(tmp, store),
                                                tmp)) for r in range(world)]
    for p in procs:
        p.start()
    return procs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("lm_sharded"))
    inputs = _inputs()
    C._dump(os.path.join(tmp, "inputs.pkl"), inputs)
    t0 = time.monotonic()
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.path.join(REPO, "tests")]))
    log = open(os.path.join(tmp, "jax.log"), "w")
    ref_proc = subprocess.Popen([sys.executable, C.__file__, tmp], env=env,
                                stdout=log, stderr=subprocess.STDOUT)
    ranks = _spawn(C.torch_rank, C.WORLD, tmp, "store")
    try:
        single = _reference_runs(inputs)
        port = _join(ranks, tmp, "port", t0)
        rc = ref_proc.wait(max(DEADLINE_S - (time.monotonic() - t0), 1))
        log.close()
        if rc != 0:
            pytest.fail(open(os.path.join(tmp, "jax.log")).read()[-4000:])
        with open(os.path.join(tmp, "jax.pkl"), "rb") as f:
            sharded_ref = pickle.load(f)
    finally:
        for p in ranks:
            if p.is_alive():
                p.kill()
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.wait(10)
    return {"single": single, "port": port, "ref": sharded_ref}


def _case(runs, name):
    got = runs["port"][name]
    assert "error" not in got, got.get("error")
    return got


# ------------------------------------------------------------ train steps
def test_sharded_step_equals_single_device_reference(runs):
    got = _case(runs, "train_smollm")
    np.testing.assert_allclose(got["losses"], runs["single"]["smollm"],
                               rtol=STEP_RTOL)
    assert got["step"] == C.TRAIN["smollm"]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], np.asarray(tree)


def test_sharded_state_equals_single_device_reference(runs):
    """The placed state after the steps, gathered into the reference's
    layout by the bridge, against the reference's single-device state:
    parameters within ``rtol=1e-5, atol=2e-5`` and the moments within
    ``rtol=1e-5, atol=1e-6`` (tests/test_torch_train.py's bounds: Adam
    carries a gradient's relative rounding into the update), the
    counters exactly."""
    got = dict(_leaves(_case(runs, "train_smollm")["state"]))
    want = dict(_leaves(runs["single"]["smollm_state"]))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(got[path], w, err_msg=path)
        else:
            tol = (dict(rtol=1e-5, atol=2e-5) if path.startswith("params")
                   else dict(rtol=1e-5, atol=1e-6))
            np.testing.assert_allclose(got[path], w, err_msg=path, **tol)


def test_state_is_placed_by_the_specs(runs):
    """Vocab-parallel embedding, column/row-parallel attention and MLP,
    replicated norms; the moments add the data axis (ZeRO-1)."""
    got = _case(runs, "train_smollm")
    pl, mo = got["placements"], got["moments"]
    assert pl["embed.table"] == "(Replicate(), Shard(dim=0))"
    assert pl["segments.0.0.attn.wq.w"] == "(Replicate(), Shard(dim=1))"
    assert pl["segments.0.1.attn.wo.w"] == "(Replicate(), Shard(dim=0))"
    assert pl["segments.0.0.norm1.scale"] == "(Replicate(), Replicate())"
    assert mo["embed.table"] == "(Shard(dim=1), Shard(dim=0))"
    assert mo["segments.0.0.attn.wq.w"] == "(Shard(dim=0), Shard(dim=1))"
    assert mo["segments.0.0.norm1.scale"] == "(Shard(dim=0), Replicate())"


@pytest.mark.parametrize("layout", ["tp", "dp"])
def test_rwkv_layouts_equal_single_device(runs, layout):
    got = _case(runs, f"train_rwkv_{layout}")
    np.testing.assert_allclose(got["losses"], runs["single"]["rwkv"],
                               rtol=STEP_RTOL)


def test_dp_layout_equals_tp_layout(runs):
    np.testing.assert_allclose(_case(runs, "train_rwkv_dp")["losses"],
                               _case(runs, "train_rwkv_tp")["losses"],
                               rtol=STEP_RTOL)


@pytest.mark.parametrize("impl", ["dense", "shard_map", "shard_map_wg"])
def test_moe_train_step_equals_dense_reference(runs, impl):
    got = _case(runs, f"train_moe_{impl}")
    rtol = STEP_RTOL if impl == "dense" else MOE_RTOL
    np.testing.assert_allclose(got["losses"], runs["single"]["moe"],
                               rtol=rtol)
    if impl != "dense":       # the expert-parallel schedule ran
        assert got["ledger"]["all-to-all"] > 0, got["ledger"]
        assert got["ledger"]["all-gather"] > 0, got["ledger"]


# ---------------------------------------------------- the sharded layers
@pytest.mark.parametrize("impl", ["shard_map", "shard_map_wg"])
def test_moe_layer_sharded_equals_reference_sharded(runs, impl):
    got = _case(runs, f"moe_layer_{impl}")
    want = runs["ref"][f"moe_layer_{impl}"]
    tol = F32 if impl == "shard_map_wg" else dict(rtol=0,
                                                  atol=BF16_SUM_ATOL)
    np.testing.assert_allclose(got["out"], want["out"], **tol)
    for k, v in want["aux"].items():
        np.testing.assert_allclose(got["aux"][k], v, rtol=1e-5, err_msg=k)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k, v in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k], v, err_msg=k, **tol)
    ops = {"shard_map": {"all-to-all", "all-reduce", "all-gather"},
           "shard_map_wg": {"all-to-all", "all-gather"}}[impl]
    assert ops <= set(got["ledger"]), got["ledger"]


@pytest.mark.parametrize("key", ["deepseek", "danube"])
def test_block_sharded_equals_reference_sharded(runs, key):
    """Megatron-SP on (2, 2): deepseek (K/V heads split over model) and
    danube (sliding window, one K/V head: the replicated-KV branch)."""
    got = _case(runs, f"block_{key}")
    want = runs["ref"][f"block_{key}"]
    np.testing.assert_allclose(got["out"], want["out"], **F32)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k, v in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k], v, err_msg=k, **F32)
    assert got["ledger"].get("all-gather") and \
        got["ledger"].get("reduce-scatter"), got["ledger"]
    # the model with tp_shard_map against the reference's plain loss
    assert abs(got["loss"] - runs["single"][f"block_{key}"]) < 1e-4
    assert got["grads_finite"]


# ------------------------------------------------- restore, decode, comms
def test_elastic_restore_across_meshes(runs):
    got = _case(runs, "restore")
    assert got["at"] == 3 and got["step"] == 4
    np.testing.assert_allclose(got["loss"], runs["single"]["smollm"][3],
                               rtol=STEP_RTOL)


def test_sharded_decode_equals_unsharded(runs):
    got = _case(runs, "decode")
    assert got["placements"] == "(Shard(dim=1), Shard(dim=2))"
    np.testing.assert_allclose(got[True], got[False], rtol=1e-5, atol=1e-5)


def test_sequence_sharded_ring_is_refused(runs):
    """seq_shard_cache splits a ring of one KV head along its sequence
    (the reference's flash-decode layout); the port places it but no
    step may attend over a slice of the ring."""
    got = _case(runs, "decode")
    assert got["seq_sharded_ring"] == "(Shard(dim=1), Shard(dim=3))"
    assert "seq_shard_cache" in got["seq_sharded_refused"]


def test_crosspod_allreduce_compressed(runs):
    got = _case(runs, "crosspod")
    assert got["err"] < 1e-6 and got["ef_equal"]


# --------------------------------------------------- the dry run's counts
def test_dry_run_collectives_equal_four_gloo_ranks(runs):
    """The dry run's collective count on a fake world: the smollm
    configuration's train step with its arguments on the meta device,
    placed on a (2, 2) mesh over a fake process group of four ranks
    (``dryrun.sharded_step_costs``, as the dry run's cells run on 256 or
    512), records per op the same collectives — count, bytes of every
    execution, one-body bytes and ring wire bytes — as rank 0 of the four
    real gloo ranks records for one step of the same configuration on
    real values."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import ARCHS
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    want = _case(runs, "costs_smollm")
    cfg = C.config(ARCHS, "smollm")
    shape = ShapeSpec("train", "train", C.SEQ, C.BATCH["smollm"])
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=C.WORLD)
    try:
        mesh = make_host_mesh(C.MESH, device_type="cpu")
        model, trees, mb = dryrun.cell_arguments(cfg, shape, mesh)
        assert mb == 1
        got, nbytes = dryrun.sharded_step_costs(cfg, shape, model, trees,
                                                mb, mesh)
    finally:
        dist.destroy_process_group()
    assert got.count == want["count"]
    assert got.loop_bytes == want["loop_bytes"]
    assert got.raw_bytes == want["raw_bytes"]
    assert got.wire_bytes == want["wire_bytes"]
    assert set(got.count) == {"all-reduce", "all-gather", "reduce-scatter"}
    assert got.unknown_trip_whiles == 0
    # the layer loop (2 layers): one body's bytes below the step's
    assert got.raw_bytes["all-reduce"] < got.loop_bytes["all-reduce"]
    assert nbytes > 0


# -------------------------------------------------------------- launcher
def test_launcher_sharded_path_runs(runs):
    got = _case(runs, "launch")
    assert got["steps"] == 3 and np.isfinite(got["loss"])


def test_launcher_refuses_a_world_of_another_size(runs):
    msg = _case(runs, "launch")["refusal"]
    assert "256" in msg and "world has 4" in msg, msg


def test_launcher_refuses_without_a_world():
    with pytest.raises(SystemExit, match="torchrun"):
        launcher.main(["--arch", "smollm-360m", "--reduced", "--device",
                       "cpu", "--mesh", "single", "--steps", "1"])


def test_dry_run_replays_the_microbatch_loop_exactly():
    """The dry run runs a step's first microbatch alone and lets it stand
    for every microbatch (each is one program on the meta device): at
    microbatches 4 the replayed record equals the whole loop's, op by
    op, on a fake (2, 2) world."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import ARCHS
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    cfg = C.config(ARCHS, "smollm")
    shape = ShapeSpec("train", "train", C.SEQ, 8)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=C.WORLD)
    try:
        mesh = make_host_mesh(C.MESH, device_type="cpu")
        got = {}
        for replay in (True, False):
            model, trees, _ = dryrun.cell_arguments(cfg, shape, mesh)
            got[replay] = dryrun.sharded_step_costs(
                cfg, shape, model, trees, 4, mesh, replay=replay)
    finally:
        dist.destroy_process_group()
    (one, one_bytes), (whole, whole_bytes) = got[True], got[False]
    assert one == whole
    assert one.loop_bytes["all-reduce"] > one.raw_bytes["all-reduce"]
    # the bytes after the loop (the metrics of 4 microbatches, stacked)
    # are one microbatch's
    assert abs(one_bytes - whole_bytes) < 1e-4 * whole_bytes

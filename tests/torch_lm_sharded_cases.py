"""The four-rank runs of test_torch_lm_sharded.py: the port on four
``gloo`` ranks on the CPU (``torch_rank``, started through
``torch.multiprocessing``) and the reference's sharded layers on four virtual
XLA devices (``jax_main``, a subprocess with
``--xla_force_host_platform_device_count=4``). Each process reads the
inputs the test wrote (numpy, from the reference's initializers) and
writes one pickle of its results. Each side imports only its own
package; the configurations are the reference tests' own
(tests/test_sharding_multidev.py), on a (2, 2) mesh.
"""
import dataclasses
import os
import pickle
import sys
import traceback

import numpy as np

WORLD = 4
MESH = (2, 2)

#: (arch, changes to .reduced()) of the reference tests
CONFIGS = {
    "smollm": ("smollm-360m", dict(d_model=64, n_heads=4, n_kv_heads=2,
                                   d_ff=128, vocab=256, n_layers=2,
                                   param_dtype="float32")),
    "rwkv": ("rwkv6-3b", dict(d_model=64, n_layers=2, vocab=256, d_ff=128,
                              param_dtype="float32", head_dim=32,
                              n_heads=2, n_kv_heads=2)),
    "moe": ("qwen3-moe-235b-a22b", dict(param_dtype="float32")),
    "deepseek": ("deepseek-7b", dict(param_dtype="float32", n_heads=4,
                                     n_kv_heads=4)),
    # q heads split over model, one KV head: the replicated-KV branch
    "danube": ("h2o-danube-3-4b", dict(param_dtype="float32", n_heads=4,
                                       n_kv_heads=1, sliding_window=16)),
    "decode": ("h2o-danube-3-4b", dict(n_heads=4, n_kv_heads=4)),
}
#: (config, global batch, steps) of each train run
TRAIN = {"smollm": 4, "rwkv": 3, "moe": 3}
BATCH = {"smollm": 4, "rwkv": 8, "moe": 8}
SEQ = 32
HP = dict(total_steps=10)
MOE_X = (4, 16, 128)
BLOCK_X = (2, 32, 128)
DECODE_STEPS = 4


def config(archs, key, **extra):
    """The configuration ``key`` from ``archs`` (either package's
    ``ARCHS``)."""
    arch, changes = CONFIGS[key]
    cfg = archs[arch].reduced().replace(**changes)
    if key == "moe":
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, n_experts=8, top_k=2, d_expert=64, capacity_factor=8.0))
    return cfg.replace(**extra)


def _dump(path, obj):
    with open(path + ".tmp", "wb") as f:
        pickle.dump(obj, f)
    os.replace(path + ".tmp", path)


# --------------------------------------------------------------- the port

def _port_cases(inputs, tmp, rank):
    import torch
    import torch.distributed as dist

    from repro_torch import bridge
    from repro_torch.configs import ARCHS
    from repro_torch.distributed import collectives
    from repro_torch.distributed.compress import (
        compress_grads,
        crosspod_allreduce_compressed,
        ef_init,
    )
    from repro_torch.distributed.context import mesh_context
    from repro_torch.distributed.sharding import (
        batch_shardings,
        distribute,
        params_shardings,
        place,
        place_module,
        states_shardings,
    )
    from repro_torch.distributed.spmd import full_tensor
    from repro_torch.launch import train as launcher
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.api import build_model
    from repro_torch.models.block_sharded import attn_mlp_block_sharded
    from repro_torch.models.layers import Init
    from repro_torch.models.moe import init_moe
    from repro_torch.models.moe_sharded import moe_layer_sharded
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.distributed.elastic import (
        make_mesh_from_devices,
        rescale,
    )
    from repro_torch.train.step import (
        TrainHParams,
        init_train_state,
        make_train_step,
        train_batch_shardings,
        train_state_shardings,
    )

    cpu = torch.device("cpu")
    mesh = make_host_mesh(MESH, device_type="cpu")

    def tensors(b):
        return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}

    def train(key, steps, save_at=None, **extra):
        cfg = config(ARCHS, key, **extra)
        model = build_model(cfg, cpu)
        like = bridge.train_state_from_numpy(model, inputs["states"][key])
        state = bridge.train_state_from_numpy(
            model, inputs["states"][key],
            shardings=train_state_shardings(like, cfg, mesh))
        del like
        step = make_train_step(model, TrainHParams(**HP))
        collectives.LEDGER.reset()
        losses = []
        with mesh_context(mesh):
            for i, b in enumerate(inputs["batches"][key][:steps]):
                b = tensors(b)
                sh = train_batch_shardings(b, mesh, layout=cfg.layout)
                state, m = step(state, {k: distribute(v, sh[k])
                                        for k, v in b.items()})
                losses.append(float(m["loss"]))
                if i + 1 == save_at:
                    CheckpointManager(os.path.join(tmp, "ckpt")).save(
                        save_at, state, blocking=True)
        placements = {n: str(p.placements) for n, p in
                      state.params.named_parameters()}
        moments = {n: str(m.placements) for n, m in state.opt.mu.items()}
        final = bridge.train_state_to_numpy(state)   # every rank gathers
        return {"losses": losses, "step": int(full_tensor(state.step)),
                "state": final,
                "ledger": dict(collectives.LEDGER.count),
                "placements": placements, "moments": moments}

    def moe_layer(impl):
        cfg = config(ARCHS, "moe", moe_impl=impl)
        p = init_moe(Init(cpu, None), cfg)
        ref = inputs["layers"]["moe_params"]
        with torch.no_grad():
            for name, t in p.named_parameters():
                node = ref
                for part in name.split("."):
                    node = node[part]
                t.copy_(torch.from_numpy(node))
        p.requires_grad_(True)
        x = torch.from_numpy(inputs["layers"]["moe_x"]).requires_grad_(True)
        c = torch.from_numpy(inputs["layers"]["moe_c"])
        collectives.LEDGER.reset()
        out, aux = moe_layer_sharded(p, x, cfg, mesh)
        out = full_tensor(out)
        aux = {k: full_tensor(v) for k, v in aux.items()}
        f = ((out * c).sum() + 0.3 * aux["load_balance_loss"]
             + 0.7 * aux["router_z_loss"])
        names = [n for n, _ in p.named_parameters()]
        grads = torch.autograd.grad(f, list(p.parameters()) + [x])
        return {"out": out.detach().numpy(),
                "aux": {k: float(v) for k, v in aux.items()},
                "grads": {n: g.numpy() for n, g in zip(names + ["x"],
                                                       grads)},
                "ledger": dict(collectives.LEDGER.count)}

    def block(key):
        cfg = config(ARCHS, key)
        model = build_model(cfg, cpu)
        params = bridge.lm_params_from_numpy(model,
                                             inputs["layers"]["block"][key])
        lp = params.segments[0][0]
        lp.requires_grad_(True)
        x = torch.from_numpy(inputs["layers"]["block_x"]).requires_grad_(True)
        c = torch.from_numpy(inputs["layers"]["block_c"])
        collectives.LEDGER.reset()
        out = full_tensor(attn_mlp_block_sharded(
            lp, x, cfg, positions=torch.arange(BLOCK_X[1]),
            window=cfg.sliding_window, mesh=mesh))
        names = [n for n, _ in lp.named_parameters()]
        grads = torch.autograd.grad((out * c).sum(),
                                    list(lp.parameters()) + [x])
        # the whole model with tp_shard_map: its loss and gradients
        m2 = build_model(cfg.replace(tp_shard_map=True), cpu)
        p2 = bridge.lm_params_from_numpy(m2, inputs["layers"]["block"][key])
        p2.requires_grad_(True)
        place_module(p2, params_shardings(p2, m2.cfg, mesh))
        b = tensors(inputs["layers"]["block_batch"])
        sh = batch_shardings(b, mesh)
        with mesh_context(mesh):
            loss, _ = m2.loss(p2, {k: distribute(v, sh[k])
                                   for k, v in b.items()})
            loss = full_tensor(loss)
            g = torch.autograd.grad(loss, list(p2.parameters()))
        finite = all(bool(torch.isfinite(full_tensor(t)).all()) for t in g)
        return {"out": out.detach().numpy(),
                "grads": {n: gr.numpy() for n, gr in zip(names + ["x"],
                                                         grads)},
                "ledger": dict(collectives.LEDGER.count),
                "loss": float(loss), "grads_finite": finite}

    def decode():
        cfg = config(ARCHS, "decode")
        model = build_model(cfg, cpu)
        tokens = torch.from_numpy(inputs["decode_tokens"])
        outs = {}
        for sharded in (False, True):
            params = model.init(0, device=cpu)
            states = model.init_states(4, 64)
            if sharded:
                place_module(params, params_shardings(params, cfg, mesh))
                states = place(states, states_shardings(
                    states, cfg, mesh, global_batch=4))
            logits = []
            with mesh_context(mesh if sharded else None):
                prompt = {"tokens": tokens[:, :8]}
                tok = tokens[:, 8:9]
                if sharded:
                    prompt = {"tokens": distribute(
                        prompt["tokens"],
                        batch_shardings(prompt, mesh)["tokens"])}
                lg, states = model.prefill(params, prompt, states)
                logits.append(full_tensor(lg))
                for i in range(DECODE_STEPS):
                    t = tokens[:, 8 + i:9 + i]
                    if sharded:
                        t = distribute(t, batch_shardings({"t": t},
                                                          mesh)["t"])
                    lg, states = model.decode_step(params, t, states)
                    logits.append(full_tensor(lg))
            outs[sharded] = torch.stack(logits).numpy()
            if sharded:
                outs["placements"] = str(states["segs"][0]["kv"].k.placements)
        # one KV head with seq_shard_cache: the ring is split along its
        # sequence, which no step may attend over
        cfg = config(ARCHS, "decode", n_kv_heads=1, seq_shard_cache=True)
        model = build_model(cfg, cpu)
        params = model.init(0, device=cpu)
        place_module(params, params_shardings(params, cfg, mesh))
        states = model.init_states(4, 64)
        states = place(states, states_shardings(states, cfg, mesh,
                                                global_batch=4))
        outs["seq_sharded_ring"] = str(states["segs"][0]["kv"].k.placements)
        try:
            model.prefill(params, {"tokens": distribute(
                tokens[:, :8], batch_shardings({"t": tokens[:, :8]},
                                               mesh)["t"])}, states)
        except NotImplementedError as e:
            outs["seq_sharded_refused"] = str(e)
        return outs

    def crosspod():
        pmesh = make_host_mesh((2, 1, 2), ("pod", "data", "model"),
                               device_type="cpu")

        def grads_of(r):
            g = torch.Generator().manual_seed(100 + r)
            return {"a": torch.randn(6, 5, generator=g),
                    "b": torch.randn(7, generator=g)}

        mine = grads_of(rank)
        reduced, ef = crosspod_allreduce_compressed(mine, ef_init(mine),
                                                    mesh=pmesh)
        pod_ranks = [r for r in range(WORLD) if r % 2 == rank % 2]
        comp = [compress_grads(grads_of(r), ef_init(mine))[0]
                for r in pod_ranks]
        want = {k: sum(c[k] for c in comp) / len(comp) for k in mine}
        _, want_ef = compress_grads(mine, ef_init(mine))
        return {"err": max(float((reduced[k] - want[k]).abs().max())
                           for k in mine),
                "ef_equal": all(torch.equal(ef.residual[k],
                                            want_ef.residual[k])
                                for k in mine)}

    def launch():
        out = {}
        try:
            launcher.main(["--arch", "smollm-360m", "--reduced", "--device",
                           "cpu", "--mesh", "single", "--steps", "1"])
        except SystemExit as e:
            out["refusal"] = str(e)
        real = launcher.make_production_mesh
        launcher.make_production_mesh = lambda **kw: make_host_mesh(
            MESH, device_type="cpu")
        try:
            rep = launcher.main(["--arch", "smollm-360m", "--reduced",
                                 "--device", "cpu", "--mesh", "single",
                                 "--steps", "3", "--batch", "4", "--seq",
                                 "32", "--ckpt-dir",
                                 os.path.join(tmp, "launch_ckpt")])
        finally:
            launcher.make_production_mesh = real
        out.update(steps=rep.steps_run, loss=rep.final_metrics["loss"])
        return out

    def restore():
        """The step-3 checkpoint of the (2, 2) run onto a (2, 1) mesh over
        ranks 0 and 1 (as the reference's test restores onto some of its
        devices), and the fourth step there."""
        cfg = config(ARCHS, "smollm")
        model = build_model(cfg, cpu)
        mesh2 = make_mesh_from_devices([0, 1], (2, 1), ("data", "model"),
                                       device_type="cpu")
        if mesh2.get_coordinate() is None:
            return {}
        like = init_train_state(model, 1, device=cpu)   # other values
        state, _, at = rescale(CheckpointManager(os.path.join(tmp, "ckpt")),
                               like, cfg, mesh2)
        b = tensors(inputs["batches"]["smollm"][3])
        sh = train_batch_shardings(b, mesh2)
        with mesh_context(mesh2):
            state, m = make_train_step(model, TrainHParams(**HP))(
                state, {k: distribute(v, sh[k]) for k, v in b.items()})
        return {"at": at, "step": int(full_tensor(state.step)),
                "loss": float(m["loss"])}

    cases = [
        ("train_smollm", lambda: train("smollm", TRAIN["smollm"],
                                       save_at=3)),
        ("restore", restore),
        ("train_rwkv_tp", lambda: train("rwkv", TRAIN["rwkv"])),
        ("train_rwkv_dp", lambda: train("rwkv", TRAIN["rwkv"],
                                        layout="dp")),
        ("train_moe_dense", lambda: train("moe", TRAIN["moe"])),
        ("train_moe_shard_map", lambda: train("moe", TRAIN["moe"],
                                              moe_impl="shard_map")),
        ("train_moe_shard_map_wg", lambda: train("moe", TRAIN["moe"],
                                                 moe_impl="shard_map_wg")),
        ("moe_layer_shard_map", lambda: moe_layer("shard_map")),
        ("moe_layer_shard_map_wg", lambda: moe_layer("shard_map_wg")),
        ("block_deepseek", lambda: block("deepseek")),
        ("block_danube", lambda: block("danube")),
        ("decode", decode),
        ("crosspod", crosspod),
        ("launch", launch),
    ]
    out = {}
    for name, fn in cases:
        try:
            out[name] = fn()
        except Exception:
            out[name] = {"error": traceback.format_exc()}
        dist.barrier()
    return out


def _rank(rank, world, store, tmp, run, name):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    err = os.path.join(tmp, f"{name}{rank}.err")
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world)
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        out = run(inputs, tmp, rank)
        _dump(os.path.join(tmp, f"{name}{rank}.pkl"), out)
        dist.destroy_process_group()
    except BaseException:
        with open(err, "w") as f:
            f.write(traceback.format_exc())
        raise


def torch_rank(rank, store, tmp):
    _rank(rank, WORLD, store, tmp, _port_cases, "port")


# ---------------------------------------------------------- the reference

def jax_main(tmp):
    import jax
    import jax.numpy as jnp

    from repro.configs import ARCHS
    from repro.models.api import build_model
    from repro.models.block_sharded import attn_mlp_block_sharded
    from repro.models.moe_sharded import moe_layer_sharded

    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    mesh = jax.make_mesh(MESH, ("data", "model"))
    lay = inputs["layers"]
    out = {}
    p = jax.tree_util.tree_map(jnp.asarray, lay["moe_params"])
    x, c = jnp.asarray(lay["moe_x"]), jnp.asarray(lay["moe_c"])
    for impl in ("shard_map", "shard_map_wg"):
        cfg = config(ARCHS, "moe", moe_impl=impl)

        def f(p, x):
            y, a = moe_layer_sharded(p, x, cfg, mesh)
            return (jnp.sum(y * c) + 0.3 * a["load_balance_loss"]
                    + 0.7 * a["router_z_loss"]), (y, a)

        (_, (y, a)), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(p, x)
        grads = {"router.w": gp["router"]["w"], "x": gx}
        for n in ("w_gate", "w_up", "w_out"):
            grads[f"experts.{n}"] = gp["experts"][n]
        out[f"moe_layer_{impl}"] = {
            "out": np.asarray(y), "aux": {k: float(v) for k, v in a.items()},
            "grads": {k: np.asarray(v) for k, v in grads.items()}}
    names = {"norm1.scale": ("norm1", "scale"), "attn.wq.w": ("attn", "wq"),
             "attn.wk.w": ("attn", "wk"), "attn.wv.w": ("attn", "wv"),
             "attn.wo.w": ("attn", "wo"), "norm2.scale": ("norm2", "scale"),
             "mlp.w_gate.w": ("mlp", "w_gate"), "mlp.w_up.w": ("mlp", "w_up"),
             "mlp.w_out.w": ("mlp", "w_out")}
    x, c = jnp.asarray(lay["block_x"]), jnp.asarray(lay["block_c"])
    for key in ("deepseek", "danube"):
        cfg = config(ARCHS, key)
        params = jax.tree_util.tree_map(jnp.asarray, lay["block"][key])
        lp = jax.tree_util.tree_map(lambda a: a[0], params["segments"][0])

        def f(lp, x):
            y = attn_mlp_block_sharded(lp, x, cfg,
                                       positions=jnp.arange(BLOCK_X[1]),
                                       window=cfg.sliding_window, mesh=mesh)
            return jnp.sum(y * c), y

        (_, y), (gl, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(lp, x)
        grads = {"x": np.asarray(gx)}
        for n, (a, b) in names.items():
            leaf = gl[a][b]
            grads[n] = np.asarray(leaf["w"] if isinstance(leaf, dict)
                                  else leaf)
        out[f"block_{key}"] = {"out": np.asarray(y), "grads": grads}
    _dump(os.path.join(tmp, "jax.pkl"), out)


if __name__ == "__main__":
    jax_main(sys.argv[1])

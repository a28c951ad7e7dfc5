"""Multi-pod dry run on the meta device.

Port of ``repro/launch/dryrun.py``. For every (architecture × input shape
× mesh) cell the reference lowers and compiles the real step (train step,
prefill or decode) with production shardings on 256 or 512 virtual
devices and records XLA's memory and cost analyses. The port has no
compiler to ask: it builds the model and the train state (or the serving
states) on ``torch.device("meta")`` (shapes and dtypes, no storage),
applies the same specs on the production ``LogicalMesh`` and records what
it can compute itself, under the reference's record keys:

  status / skip_reason   ``configs.applicable``
  microbatches           ``_microbatch_plan`` (train cells)
  gqa_expand             as the reference sets it
  memory.argument_bytes  per rank: each argument leaf's local shard
                         (its ``NamedSharding.shard_shape``), summed
  memory.output_bytes    per rank, the outputs the reference's step
                         returns placed as its out_shardings say (the
                         state; the metrics, logits replicated)
  cost_analysis.flops    ``torch.utils.flop_counter.FlopCounterMode`` over
                         the whole step on the meta device (every layer
                         and microbatch: the logical step, all ranks
                         together) -- not the reference's count, which
                         XLA makes once per loop body per device
  collectives            ``launch/hlo_analysis.py``'s ``CollectiveStats``
                         of rank 0's sharded step: the process is made
                         rank 0 of a fake process group of the production
                         mesh's size (``FakeStore``, backend ``"fake"``: a
                         collective returns at once and moves nothing),
                         the arguments are placed on that ``DeviceMesh``
                         on the meta device, and the step runs under the
                         cost recorder (``obs/costs.py``): DTensor's
                         redistributes through its dispatch mode, the
                         sharded layers' own collectives at their call
                         sites. The layer and microbatch loops enter the
                         recorder's ``loop``, so ``raw_bytes`` is one body
                         and ``loop_bytes`` the whole step, per rank (the
                         first microbatch runs and stands for the others:
                         one program, ``replayed_train_step``)
  cost_analysis.bytes_accessed  the same run's bytes (every op's inputs
                         and outputs, an indexing op's by the elements it
                         touches, per rank; ``obs.costs.record_call``)

A cell whose sharded step cannot run on the meta device (a data-dependent
op, say) writes null collectives and bytes accessed with the reason in
``not_measured``; so do the quantities only a compiled XLA program has --
``temp_bytes``, ``code_bytes``, ``alias_bytes``, ``transcendentals``. None
is estimated, and no cell changes its status for it.

Usage (artifacts under build/dryrun, one JSON per cell):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The command line counts the collectives of every cell it runs;
``run_cell(collectives=False)`` places the arguments alone (~0.1 s a
cell). ``--all`` runs each cell in a fresh process and tolerates
per-cell failures: a failing cell records its error and the run
continues.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

ARTIFACT_DIR = "build/dryrun"
MODEL_AXIS = 16

NOT_MEASURED = {
    "temp_bytes": "no compiled XLA program: its temp buffers do not "
                  "exist, and a meta step allocates nothing",
    "code_bytes": "no compiled XLA program: no generated code",
    "alias_bytes": "no compiled XLA program: no donated buffers",
    "transcendentals": "the cost mode counts an elementwise op's output "
                       "elements as FLOPs; XLA's separate transcendental "
                       "count has no counterpart",
}


def _microbatch_plan(cfg, shape, mesh_devices: int, data_shards: int) -> int:
    """Grad accumulation so the per-device residual-stream activation
    memory (L·(B/d)·T·D·2 bytes) stays under ~4 GiB: powers of two,
    capped at the local batch (the reference's rule)."""
    if cfg.layout == "dp":
        data_shards = mesh_devices     # batch is sharded over every axis
    local_b = max(1, shape.global_batch // data_shards)
    bytes_act = (cfg.n_layers * local_b * shape.seq_len * cfg.d_model * 2)
    budget = 4 * 1024**3
    mb = 1
    while bytes_act / mb > budget and mb < local_b:
        mb *= 2
    return mb


# the reference's optimized variants (applied with --opt; artifacts get
# the "__opt" suffix)
OPTIMIZED = {
    "h2o-danube-3-4b": dict(tp_shard_map=True),
    "deepseek-7b": dict(tp_shard_map=True),
    "rwkv6-3b": dict(layout="dp"),
    "hymba-1.5b": dict(layout="dp"),
    "smollm-360m": dict(layout="dp"),
    "seamless-m4t-medium": dict(layout="dp"),
    "qwen3-moe-235b-a22b": dict(moe_impl="shard_map_wg",
                                seq_shard_cache=True),
    "arctic-480b": dict(moe_impl="shard_map", seq_shard_cache=True),
    "qwen1.5-32b": dict(seq_shard_cache=True,
                        kv_cache_dtype="float8_e4m3fn"),
    "internvl2-76b": dict(seq_shard_cache=True, tp_shard_map=True),
}


def _mesh_size(mesh) -> int:
    """Ranks of a ``LogicalMesh`` or a ``DeviceMesh``."""
    from repro_torch.distributed.sharding import mesh_axes

    return math.prod(mesh_axes(mesh).values())


def _local_bytes(tree, shardings: dict) -> int:
    """Per-rank bytes of a tree's leaves placed by ``shardings``."""
    from repro_torch.utils.pytree import named_leaves

    total = 0
    for name, t in named_leaves(tree):
        shape = shardings[name].shard_shape(tuple(t.shape))
        total += math.prod(shape) * t.element_size()
    return total


def cell_arguments(cfg, shape, mesh):
    """(cfg, model, the step's argument trees on the meta device, their
    shardings, microbatches or None): the train state and the batch, or
    the parameters, the batch (or the token) and the states."""
    from repro_torch.distributed.sharding import (
        batch_shardings,
        data_size,
        params_shardings,
        states_shardings,
    )
    from repro_torch.models.api import build_model, input_specs
    from repro_torch.train.optim import adamw_init
    from repro_torch.train.step import TrainState, train_state_shardings

    import torch

    model = build_model(cfg, "meta")
    params = model.empty_params()
    batch = input_specs(cfg, shape)
    if shape.kind == "train":
        mb = _microbatch_plan(cfg, shape, _mesh_size(mesh), data_size(mesh))
        state = TrainState(params=params, opt=adamw_init(params),
                           step=torch.zeros((), dtype=torch.int32,
                                            device="meta"))
        ssh = train_state_shardings(state, cfg, mesh)
        flat_sh = {}
        for part, sh in (("params", ssh.params), ("opt.mu", ssh.opt.mu),
                         ("opt.nu", ssh.opt.nu)):
            flat_sh.update({f"{part}.{k}": v for k, v in sh.items()})
        flat_sh["opt.count"] = ssh.opt.count
        flat_sh["step"] = ssh.step
        bsh = batch_shardings(batch, mesh, layout=cfg.layout)
        return model, [(state, flat_sh), (batch, bsh)], mb
    states = model.init_states(shape.global_batch, shape.seq_len)
    psh = params_shardings(params, cfg, mesh)
    ssh = states_shardings(states, cfg, mesh,
                           global_batch=shape.global_batch)
    bsh = batch_shardings(batch, mesh, layout=cfg.layout)
    if shape.kind == "decode":
        batch = {"token": batch["token"]}
    return model, [(params, psh), (batch, bsh), (states, ssh)], None


def step_flops(model, shape, trees) -> int:
    """FLOPs of the whole step on the meta device (all ranks together)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        if shape.kind == "train":
            state, batch = trees[0][0], trees[1][0]
            params = state.params
            params.requires_grad_(True)
            loss, _ = model.loss(params, batch)
            torch.autograd.grad(loss, list(params.parameters()),
                                allow_unused=True)
        elif shape.kind == "prefill":
            model.prefill(trees[0][0], trees[1][0], trees[2][0])
        else:
            model.decode_step(trees[0][0], trees[1][0]["token"],
                              trees[2][0])
    return int(fc.get_total_flops())


def _fake_world(size: int) -> bool:
    """Make this process rank 0 of a fake process group of ``size`` ranks,
    unless a world of that size is up. Returns whether it made one (the
    caller destroys it); raises if a world of another size is up."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != size:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is up: "
                f"no fake world of {size} can be made in this process")
        return False
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    return True


def replayed_train_step(model, n_micro: int):
    """The train step of ``n_micro`` microbatches with its microbatch
    loop replayed, for a cost recorder on the meta device: the first
    microbatch runs and stands for every one (``CostRecorder.loop``'s
    ``run``), then the update, as ``train.step.make_train_step`` orders
    them. Each microbatch is the same program (shapes and placements
    decide its collectives, and the meta device holds no values), so its
    record is the whole loop's, as the reference's HLO walk counts the
    loop's body once times its trips; the gradients and metrics are one
    microbatch's. Meta tensors only: it raises on any other."""
    import torch

    from repro_torch.obs.costs import _plain, current_recorder
    from repro_torch.train.step import (
        TrainHParams,
        apply_update,
        loss_grads,
    )
    from repro_torch.utils.pytree import named_leaves

    grads_of = loss_grads(model)
    hp = TrainHParams(microbatches=n_micro)

    def step(state, batch):
        named = dict(named_leaves(state.params))
        leaves = list(named.values())
        if any(_plain(t).device.type != "meta"
               for t in [*leaves, *batch.values()]):
            raise ValueError("a replayed step runs on the meta device only")
        rec = current_recorder()
        if rec is None:
            raise ValueError("a replayed step runs under a cost recorder")
        rows = {k: v.shape[0] for k, v in batch.items()}
        if any(r % n_micro for r in rows.values()):
            raise ValueError(f"batch rows {rows} do not split into "
                             f"{n_micro} microbatches")
        gsum = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        with rec.loop(n_micro, run=1):
            g, metrics = grads_of(state.params, leaves,
                                  {k: v[:v.shape[0] // n_micro]
                                   for k, v in batch.items()})
            for acc, gi in zip(gsum, g):
                acc.add_(gi)
        return apply_update(hp, state, named,
                            [acc.div_(n_micro) for acc in gsum], metrics)

    return step


def sharded_step_costs(cfg, shape, model, trees, mb, mesh, *,
                       replay: bool = True):
    """Rank 0's step on the meta device, its arguments (``cell_arguments``'
    trees) placed on the ``DeviceMesh`` ``mesh``, run once under the cost
    recorder: (``CollectiveStats``, bytes accessed per rank). The train
    state's parameters are placed in place. With ``replay`` a train step
    of more than one microbatch is ``replayed_train_step``; without, the
    step of ``make_train_step`` runs every microbatch. The layers all
    run (their backward runs after the layer loop)."""
    import torch

    from repro_torch.distributed.context import mesh_context
    from repro_torch.distributed.sharding import (
        distribute,
        place,
        place_module,
    )
    from repro_torch.launch.hlo_analysis import analyze_collectives
    from repro_torch.obs.costs import record_call
    from repro_torch.train.step import (
        TrainHParams,
        make_train_step,
        place_train_state,
        train_state_shardings,
    )

    if shape.kind == "train":
        (state, _), (batch, bsh) = trees
        state.params.requires_grad_(True)
        state = place_train_state(state,
                                  train_state_shardings(state, cfg, mesh))
        n_micro = mb or 1
        step = (replayed_train_step(model, n_micro)
                if replay and n_micro > 1 else
                make_train_step(model, TrainHParams(microbatches=n_micro)))

        def fn(b):
            return step(state, b)
    else:
        (params, psh), (batch, bsh), (states, ssh) = trees
        place_module(params, psh)
        states = place(states, ssh)

        def fn(b):
            with torch.no_grad():
                if shape.kind == "prefill":
                    return model.prefill(params, b, states)
                return model.decode_step(params, b["token"], states)

    batch = {k: distribute(v, bsh[k]) for k, v in batch.items()}
    with mesh_context(mesh):
        rec = record_call(fn, batch)
    return analyze_collectives(rec.trace), rec.bytes_accessed


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             opt: bool = False, flops: bool = True,
             verbose: bool = True, collectives: bool = False) -> dict:
    """One cell's record (also written to ``out_dir``). ``collectives``
    runs rank 0's sharded step on a fake world (``sharded_step_costs``)
    for the collectives and bytes accessed; off, they stay null."""
    from repro_torch.configs import SHAPES, applicable, get_config
    from repro_torch.launch.mesh import (
        make_production_mesh,
        production_shape,
    )

    cfg = get_config(arch)
    if opt:
        cfg = cfg.replace(**OPTIMIZED.get(arch, {}))
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    cell_id = f"{arch}__{shape_name}__{mesh_name}" + ("__opt" if opt else "")
    out_path = os.path.join(out_dir, cell_id + ".json")
    os.makedirs(out_dir, exist_ok=True)

    ok, reason = applicable(cfg, shape)
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "opt": opt,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "kind": shape.kind, "status": "skipped", "skip_reason": reason,
    }
    if not ok:
        with open(out_path, "w") as f:
            json.dump(record, f, indent=1)
        if verbose:
            print(f"[dryrun] {cell_id}: SKIP ({reason})")
        return record

    not_measured = dict(NOT_MEASURED)
    made = False
    if collectives:
        try:
            made = _fake_world(math.prod(production_shape(multi_pod)[0]))
        except RuntimeError as e:
            collectives = False
            not_measured["collectives"] = str(e)
    else:
        not_measured["collectives"] = ("not counted: placement only "
                                       "(run_cell(collectives=False))")
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        cfg = cfg.replace(gqa_expand=(cfg.n_heads % MODEL_AXIS == 0
                                      and cfg.n_kv_heads % MODEL_AXIS != 0))
        record["gqa_expand"] = cfg.gqa_expand
        t0 = time.time()
        model, trees, mb = cell_arguments(cfg, shape, mesh)
        if mb is not None:
            record["microbatches"] = mb
        arg_bytes = sum(_local_bytes(t, sh) for t, sh in trees)
        out_bytes = _local_bytes(*trees[0]) if shape.kind == "train" else \
            _local_bytes(*trees[-1])
        t_place = time.time() - t0
        t0 = time.time()
        n_flops = step_flops(model, shape, trees) if flops else None
        t_trace = time.time() - t0
        colls = n_bytes = None
        t0 = time.time()
        if collectives:
            try:
                colls, n_bytes = sharded_step_costs(cfg, shape, model,
                                                    trees, mb, mesh)
            except Exception as e:  # noqa: BLE001 - recorded, not raised
                not_measured["collectives"] = (
                    f"rank 0's sharded step did not run on the meta "
                    f"device: {type(e).__name__}: {str(e)[:400]}")
        if n_bytes is None:
            not_measured["bytes_accessed"] = not_measured["collectives"]
    finally:
        if made:
            import torch.distributed as dist

            dist.destroy_process_group()
    record.update({
        "status": "ok",
        "place_s": round(t_place, 2),
        "trace_s": round(t_trace, 2),
        "collectives_s": round(time.time() - t0, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": None, "code_bytes": None, "alias_bytes": None,
        },
        "cost_analysis": {
            "flops": n_flops,           # None: counted with --no-flops off
            "flops_scope": "the whole logical step (all ranks, every "
                           "layer and microbatch), FlopCounterMode on "
                           "the meta device",
            "bytes_accessed": n_bytes,
            "bytes_accessed_scope": "rank 0's sharded step, every op's "
                                    "inputs and outputs, executed",
            "transcendentals": None,
        },
        "collectives": None if colls is None else {
            "raw_bytes": colls.raw_bytes,
            "loop_bytes": colls.loop_bytes,
            "wire_bytes": colls.wire_bytes,
            "count": colls.count,
            "unknown_trip_whiles": colls.unknown_trip_whiles,
            "total_wire_bytes": colls.total_wire(),
            "scope": "rank 0's sharded step on a fake process group of "
                     f"{_mesh_size(mesh)} ranks: raw = one layer body and one "
                     "microbatch, loop = the whole step, per rank",
        },
        "not_measured": not_measured,
        "n_devices": _mesh_size(mesh),
    })
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    if verbose:
        wire = None if colls is None else f"{colls.total_wire() / 2**30:.3f}"
        print(f"[dryrun] {cell_id}: OK args={arg_bytes / 2**30:.2f}"
              f"GiB/rank flops={n_flops} wire={wire}GiB/rank")
    return record


def run_all(meshes: list[str], out_dir: str, archs=None, shapes=None,
            timeout: int = 3600, opt: bool = False, flops: bool = True):
    from repro_torch.configs import ARCHS, SHAPES

    archs = archs or list(ARCHS)
    shapes = shapes or list(SHAPES)
    results = []
    for mesh in meshes:
        for arch in archs:
            for shape in shapes:
                cell = f"{arch}__{shape}__{mesh}" + ("__opt" if opt else "")
                path = os.path.join(out_dir, cell + ".json")
                if os.path.exists(path):
                    with open(path) as f:
                        rec = json.load(f)
                    if rec.get("status") in ("ok", "skipped"):
                        print(f"[dryrun] {cell}: cached")
                        results.append(rec)
                        continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh", mesh,
                       "--out", out_dir] + (["--opt"] if opt else []) + (
                           [] if flops else ["--no-flops"])
                try:
                    proc = subprocess.run(cmd, timeout=timeout,
                                          capture_output=True, text=True)
                    if proc.returncode != 0:
                        rec = {"arch": arch, "shape": shape, "mesh": mesh,
                               "status": "error",
                               "error": proc.stderr[-2000:]}
                        with open(path, "w") as f:
                            json.dump(rec, f, indent=1)
                        print(f"[dryrun] {cell}: ERROR")
                    else:
                        sys.stdout.write(proc.stdout)
                        with open(path) as f:
                            rec = json.load(f)
                except subprocess.TimeoutExpired:
                    rec = {"arch": arch, "shape": shape, "mesh": mesh,
                           "status": "timeout"}
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    print(f"[dryrun] {cell}: TIMEOUT")
                results.append(rec)
    n_ok = sum(r.get("status") == "ok" for r in results)
    n_skip = sum(r.get("status") == "skipped" for r in results)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, "
          f"{len(results) - n_ok - n_skip} failed, of {len(results)}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--opt", action="store_true",
                    help="apply the reference's optimized variant")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--no-flops", action="store_true",
                    help="skip the FLOP count (its trace of a 32k-token "
                         "step takes tens of seconds to minutes)")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        return run_all(meshes, args.out, timeout=args.timeout, opt=args.opt,
                       flops=not args.no_flops)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape required")
    out = []
    for m in meshes:
        try:
            out.append(run_cell(args.arch, args.shape, m == "multi",
                                args.out, opt=args.opt,
                                flops=not args.no_flops,
                                collectives=True))
        except Exception:
            traceback.print_exc()
            raise
    return out


if __name__ == "__main__":
    main()

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

Quantities that only a compiled XLA program has -- ``temp_bytes``,
``code_bytes``, ``alias_bytes``, ``bytes_accessed``, ``transcendentals``
and the HLO collectives -- are written as null, with the reason in
``not_measured``; none is estimated.

Usage (artifacts under build/dryrun, one JSON per cell):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

``--all`` runs each cell in a fresh process and tolerates per-cell
failures: a failing cell records its error and the run continues.
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

NOT_MEASURED = ("no compiled XLA program: the port runs eagerly, so "
                "XLA's temp/code/alias bytes, bytes accessed, "
                "transcendentals and HLO collectives do not exist")


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
        mb = _microbatch_plan(cfg, shape, mesh.size, data_size(mesh))
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


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             opt: bool = False, flops: bool = True,
             verbose: bool = True) -> dict:
    from repro_torch.configs import SHAPES, applicable, get_config
    from repro_torch.launch.mesh import make_production_mesh

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
    record.update({
        "status": "ok",
        "place_s": round(t_place, 2),
        "trace_s": round(time.time() - t0, 2),
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
            "bytes_accessed": None, "transcendentals": None,
        },
        "collectives": None,
        "not_measured": NOT_MEASURED,
        "n_devices": mesh.size,
    })
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    if verbose:
        print(f"[dryrun] {cell_id}: OK args={arg_bytes / 2**30:.2f}"
              f"GiB/rank flops={n_flops}")
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
                                flops=not args.no_flops))
        except Exception:
            traceback.print_exc()
            raise
    return out


if __name__ == "__main__":
    main()

"""Training launcher.

Port of ``repro/launch/train.py``, with the same flags, running on the
card; ``--device cpu`` runs it on the CPU (the port's device policy: the
CPU only when named):

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 200 --batch 8 --seq 1024 --ckpt-dir build/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --reduced --device cpu --steps 3 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen3-moe-235b-a22b --reduced --device cpu --steps 3 \\
      --ckpt-dir /tmp/ckpt_moe

Every family trains on the token stream (MoE with its aux losses, hymba
with its meta tokens, the VLM without patches). The encoder-decoder
needs source frames the stream does not make: as in the reference's
launcher, its loss fails for want of ``src_embeds``.

Weights are random, drawn from ``--seed``; the data is the synthetic
stream of ``train/data.py`` from the same seed. A second run with the same
``--ckpt-dir`` resumes from its last committed step.

``--mesh single|multi`` trains on the production mesh
(``launch/mesh.py``: (data 16, model 16) or (pod 2, data 16, model 16)),
the state placed by ``train_state_shardings`` and each batch by
``train_batch_shardings``. The world comes from ``torchrun`` (NCCL on the
cards, one per rank; gloo with ``--device cpu``), and must have the
mesh's size: another size is refused with both named.

  torchrun --nproc-per-node 256 -m repro_torch.launch.train \
      --arch smollm-360m --mesh single --ckpt-dir build/ckpt
"""
from __future__ import annotations

import argparse

import os

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.distributed.context import mesh_context
from repro_torch.distributed.sharding import LogicalMesh, distribute
from repro_torch.launch.mesh import make_production_mesh, production_shape
from repro_torch.models.api import build_model
from repro_torch.train.data import DataConfig, SyntheticLMStream
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.step import (
    TrainHParams,
    init_train_state,
    make_train_step,
    place_train_state,
    train_batch_shardings,
    train_state_shardings,
)
from repro_torch.utils.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--metrics-csv", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without one)")
    ap.add_argument("--mesh", default="none",
                    choices=["none", "single", "multi"])
    args = ap.parse_args(argv)

    if args.mesh != "none":
        return _main_mesh(args)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device)

    hp = TrainHParams(peak_lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                      total_steps=args.steps,
                      microbatches=args.microbatches)
    step_fn = make_train_step(model, hp)
    state = init_train_state(model, args.seed, device=device)

    stream = SyntheticLMStream(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed))
    loop_cfg = LoopConfig(total_steps=args.steps,
                          ckpt_every=args.ckpt_every,
                          ckpt_dir=args.ckpt_dir,
                          metrics_csv=args.metrics_csv)
    state, report = train_loop(step_fn, state, stream, loop_cfg)
    print(f"[train] ran {report.steps_run} steps on {device}; "
          f"final loss={report.final_metrics.get('loss', float('nan')):.4f} "
          f"(resumed_from={report.resumed_from}, "
          f"stragglers={len(report.straggler_steps)})")
    return report


def _init_world(device_arg):
    """The world torchrun started: its process group (NCCL for the cards,
    gloo for ``--device cpu``) and this rank's device."""
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise SystemExit("--mesh needs a world of ranks: run under "
                             "torchrun")
        dist.init_process_group(
            "gloo" if device_arg == "cpu" else "nccl")
    if device_arg == "cpu":
        return torch.device("cpu")
    device = torch.device("cuda", int(os.environ.get(
        "LOCAL_RANK", dist.get_rank())) % max(torch.cuda.device_count(), 1))
    torch.cuda.set_device(device)
    return resolve_device(device)


def _main_mesh(args):
    device = _init_world(args.device)
    shape, _ = production_shape(args.mesh == "multi")
    mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                device_type=device.type)
    if isinstance(mesh, LogicalMesh):
        raise SystemExit(
            f"--mesh {args.mesh} is a mesh of {mesh.size} ranks "
            f"{tuple(shape)}; the world has {dist.get_world_size()}")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device)
    hp = TrainHParams(peak_lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                      total_steps=args.steps,
                      microbatches=args.microbatches)
    step_fn = make_train_step(model, hp)
    state = init_train_state(model, args.seed, device=device)
    state_sh = train_state_shardings(state, cfg, mesh)
    state = place_train_state(state, state_sh)

    def put_batch(batch):
        sh = train_batch_shardings(batch, mesh, layout=cfg.layout)
        return {k: distribute(v, sh[k]) for k, v in batch.items()}

    stream = SyntheticLMStream(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed))
    loop_cfg = LoopConfig(total_steps=args.steps,
                          ckpt_every=args.ckpt_every,
                          ckpt_dir=args.ckpt_dir,
                          metrics_csv=args.metrics_csv)
    with mesh_context(mesh):
        state, report = train_loop(step_fn, state, stream, loop_cfg,
                                   state_shardings=state_sh,
                                   put_batch=put_batch)
    if dist.get_rank() == 0:
        print(f"[train] ran {report.steps_run} steps on a mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} of "
              f"{device.type}; final loss="
              f"{report.final_metrics.get('loss', float('nan')):.4f} "
              f"(resumed_from={report.resumed_from}, "
              f"stragglers={len(report.straggler_steps)})")
    return report


if __name__ == "__main__":
    main()

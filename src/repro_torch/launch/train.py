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
``--ckpt-dir`` resumes from its last committed step. The reference's
``--mesh`` (the production mesh) comes with the sharded LM modules
(ROADMAP.md, queue 1, items D.6-D.7).
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.models.api import build_model
from repro_torch.train.data import DataConfig, SyntheticLMStream
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.step import (
    TrainHParams,
    init_train_state,
    make_train_step,
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
    args = ap.parse_args(argv)

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


if __name__ == "__main__":
    main()

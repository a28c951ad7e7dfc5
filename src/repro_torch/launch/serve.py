"""Serving launcher — continuous batching via the paper's protocol.

Port of ``repro/launch/serve.py``, with the same flags, running on the
card; ``--device cpu`` runs it on the CPU (the port's device policy: the
CPU only when named):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --requests 8 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
      --requests 8 --max-new 16 --max-len 2048
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
      --reduced --device cpu

Every decoder-only family serves (dense, ssm, hybrid, moe, vlm — the
last without patches: the engine takes token prompts). The
encoder-decoder takes source frames (``src_embeds``) that no request
carries, so ``--arch seamless-m4t-medium`` is refused, where the
reference's launcher fails inside its engine.

Weights are random, drawn from ``--seed``; prompts are token ids drawn
from the same seed with numpy.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.api import build_model
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.utils.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without one)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encdec:
        raise SystemExit(f"{cfg.name}: the serving engine takes token "
                         f"prompts; the encoder-decoder needs source "
                         f"frames (src_embeds), which no request carries")
    model = build_model(cfg, device)
    params = model.init(args.seed, device=device)

    engine = ServingEngine(model, params, n_slots=args.slots,
                           max_len=args.max_len,
                           prefill_chunk=args.prefill_chunk, device=device)
    rng = np.random.RandomState(args.seed)
    for i in range(args.requests):
        plen = int(rng.randint(4, args.max_len // 2))
        engine.submit(Request(
            rid=i,
            prompt=rng.randint(0, cfg.vocab, size=plen).astype(np.int32),
            max_new_tokens=args.max_new))

    t0 = time.perf_counter()
    finished = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.out_tokens) for r in finished)
    ws = engine.wave_sizes
    print(f"[serve] {len(finished)} requests, {total_tokens} tokens in "
          f"{dt:.2f}s ({total_tokens/dt:.1f} tok/s) on {device}")
    print(f"[serve] protocol iterations={engine.iterations}, "
          f"mean wave={np.mean(ws):.2f}, max wave={max(ws)}")
    for r in sorted(finished, key=lambda x: x.rid)[:4]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out_tokens}")
    return finished


if __name__ == "__main__":
    main()

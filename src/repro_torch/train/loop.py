"""Fault-tolerant training loop.

Port of ``repro/train/loop.py``:
  * periodic async checkpointing and crash-consistent resume: a restart
    picks up from the last committed step; the data pipeline is
    step-indexed, so no data state is saved;
  * straggler watchdog: per-step wall-time EWMA, seeded from the second
    step (the first includes the warm-up); steps slower than
    ``straggler_factor`` x the EWMA are recorded;
  * metrics CSV logging (step, loss, grad_norm, lr, seconds);
  * ``ElasticRescale``, the exception the environment raises when the
    device topology changed (the re-sharded restart:
    ``distributed/elastic.py``);
  * on a mesh: ``state_shardings`` places a restored state, and
    ``put_batch`` places each batch (``train/step.py``).

Each step ends in one wait for the device (the reference's
``block_until_ready``) so the watchdog times the step's work; batches
are copied to the state's device from pinned host memory.
"""
from __future__ import annotations

import csv
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.distributed.spmd import local
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import Prefetcher, SyntheticLMStream


class ElasticRescale(Exception):
    """Raised by the environment when device topology changed."""


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    ckpt_dir: str = "checkpoints"
    metrics_csv: Optional[str] = None
    straggler_factor: float = 3.0


@dataclass
class LoopReport:
    steps_run: int
    final_metrics: dict
    straggler_steps: list = field(default_factory=list)
    resumed_from: Optional[int] = None


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """numpy batch -> tensors on ``device``; to the card through pinned
    memory, asynchronously."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


def _wait(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _host_metrics(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def train_loop(step_fn: Callable, state, stream: SyntheticLMStream,
               cfg: LoopConfig, *, state_shardings=None,
               put_batch: Callable | None = None) -> tuple[Any, LoopReport]:
    """Runs step_fn until total_steps, checkpointing and resuming."""
    ckpt = CheckpointManager(cfg.ckpt_dir)
    resumed_from = None
    latest = ckpt.latest_step()
    if latest is not None:
        state, _ = ckpt.restore(state, step=latest,
                                shardings=state_shardings)
        resumed_from = latest

    step_t = local(state.step)
    start_step = int(step_t)
    prefetch = Prefetcher(stream, start_step=start_step)
    writer = None
    if cfg.metrics_csv:
        os.makedirs(os.path.dirname(cfg.metrics_csv) or ".", exist_ok=True)
        writer = open(cfg.metrics_csv, "a", newline="")
        csv_out = csv.writer(writer)

    ewma = None
    stragglers: list[int] = []
    metrics = {}
    try:
        step = start_step
        while step < cfg.total_steps:
            _, batch = prefetch.next()
            batch = batch_to_device(batch, step_t.device)
            if put_batch is not None:
                batch = put_batch(batch)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            _wait(metrics["loss"])
            dt = time.perf_counter() - t0
            # the first step includes the warm-up: seeding the EWMA with
            # it would mask real stragglers for dozens of steps
            if step == start_step:
                pass
            elif ewma is None:
                ewma = dt
            else:
                if dt > cfg.straggler_factor * ewma:
                    stragglers.append(step)
                ewma = 0.9 * ewma + 0.1 * dt
            step += 1
            if step % cfg.ckpt_every == 0 or step == cfg.total_steps:
                ckpt.save(step, state)
            if writer and step % cfg.log_every == 0:
                m = _host_metrics(metrics)
                csv_out.writerow([step, m.get("loss"), m.get("grad_norm"),
                                  m.get("lr"), dt])
                writer.flush()
    finally:
        prefetch.close()
        ckpt.wait()
        if writer:
            writer.close()

    return state, LoopReport(steps_run=step - start_step,
                             final_metrics=_host_metrics(metrics),
                             straggler_steps=stragglers,
                             resumed_from=resumed_from)

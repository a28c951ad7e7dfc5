"""LR schedules (pure functions of the step counter).

Port of ``repro/train/schedule.py``. ``step`` may be a Python int or a
tensor (the train state's step, on the card): the result is a float32
tensor on the step's device, computed there, so a train step reads its
learning rate without a host sync.
"""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int,
                    total_steps: int, final_frac: float = 0.1):
    step = _step(step)
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = ((step - warmup_steps)
            / max(total_steps - warmup_steps, 1)).clamp(0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac)
                     * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)


def linear_schedule(step, *, peak_lr: float, warmup_steps: int,
                    total_steps: int):
    step = _step(step)
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = ((step - warmup_steps)
            / max(total_steps - warmup_steps, 1)).clamp(0.0, 1.0)
    return torch.where(step < warmup_steps, warm, peak_lr * (1 - prog))

"""Public wrapper for wave-level assignment.

A CUDA tensor launches the hand-written kernel (levels.py); a CPU tensor
takes the plain version (ref.py). ``backend`` forces one: ``"cuda"`` (the
kernel — CUDA tensors only) or ``"torch"`` (the plain version on the
tensors' own device).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.levels.levels import wave_levels_cuda
from repro_torch.kernels.levels.ref import wave_levels_ref


def wave_levels(conflicts, valid, *, base=None,
                backend: str | None = None) -> torch.Tensor:
    """Wavefront levels [W] int32 from a prefix-conflict matrix.

        level[i] = max(base[i], 1 + max{ level[j] : j < i, C[i, j] })

    ``base`` (optional [W] int32, non-negative) is a per-task level floor;
    None means no floor (level 0 for tasks with no earlier conflicts).
    Invalid (padded) slots get level -1.
    """
    conflicts = conflicts.to(torch.bool).contiguous()
    valid = valid.to(torch.bool).contiguous()
    if base is not None:
        base = base.to(torch.int32).contiguous()
    if backend is None:
        backend = "cuda" if use_kernel(conflicts) else "torch"
    if backend == "cuda":
        return wave_levels_cuda(conflicts, valid, base)
    if backend == "torch":
        return wave_levels_ref(conflicts, valid, base)
    raise ValueError(f"unknown levels backend {backend!r}")

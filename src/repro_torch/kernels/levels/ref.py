"""Plain PyTorch version of wave-level assignment: a loop over rows.

    level[i] = max(base[i], 1 + max{ level[j] : C[i, j] }),  invalid -> -1

``base`` (default all-zero) is the per-task level floor. Robust to
arbitrary (not necessarily lower-triangular) matrices: entries pointing at
tasks not yet processed (j >= i) or at invalid tasks contribute the
initial level -1, i.e. nothing — the kernel's convention too.
"""
from __future__ import annotations

import torch


def wave_levels_ref(conflicts: torch.Tensor, valid: torch.Tensor,
                    base: torch.Tensor | None = None) -> torch.Tensor:
    """[W, W] bool-ish conflicts + [W] bool valid (+ optional [W] int32
    non-negative floor) -> [W] int32 levels."""
    w = conflicts.shape[0]
    conflicts = conflicts.to(torch.bool)
    valid = valid.to(torch.bool)
    if base is None:
        base = torch.zeros(w, dtype=torch.int32, device=conflicts.device)
    base = base.to(torch.int32)
    levels = torch.full((w,), -1, dtype=torch.int32, device=conflicts.device)
    for i in range(w):
        dep = torch.where(conflicts[i], levels, -1).max()
        lvl = torch.maximum(dep + 1, base[i])
        levels[i] = torch.where(valid[i], lvl, -1)
    return levels

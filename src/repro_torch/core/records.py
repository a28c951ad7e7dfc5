"""Worker-record machinery, vectorized.

Port of ``repro/core/records.py``. In the paper each worker carries a
*record* over the recipes of the tasks it has skipped; on a vector machine
the equivalent object is the *prefix-conflict matrix* over a window of W
tasks:

    C[i, j] = 1  iff  j < i  and  task_i conflicts with task_j

Row i of C is the record a worker would have accumulated after skipping
tasks j < i. Footprint models build it through the conflict kernel
(kernels/conflict), and the wave levels come from the levels kernel
(kernels/levels): hand-written CUDA for tensors on the card, the plain
PyTorch versions on the CPU.

The overlapped engine adds the record carry-over across a window
boundary: ``cross_window_conflicts`` (the rectangular block between the
next window's tasks and the previous window's not-yet-drained tail,
through the conflict kernel's block entry point) and ``carry_frontier``
(the per-task level floor that block imposes).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.obs.profiler import annotate


def prefix_conflicts(conflict_fn: Callable, recipes, valid: torch.Tensor,
                     *, strict: bool = True) -> torch.Tensor:
    """Build the strictly-lower-triangular conflict matrix from a model's
    pairwise predicate ``conflict_fn(a, b, strict=...)`` (later a vs
    earlier b), broadcast over all pairs of the window. Returns C [W, W]
    bool, zero outside j < i or where either task is invalid."""
    w = valid.shape[0]
    rows = {k: x[:, None] for k, x in recipes.items()}
    cols = {k: x[None, :] for k, x in recipes.items()}
    with annotate("protocol.conflict_predicate"):
        conf = conflict_fn(rows, cols, strict=strict)
    lower = torch.ones((w, w), dtype=torch.bool,
                       device=valid.device).tril(diagonal=-1)
    return conf & lower & valid[:, None] & valid[None, :]


def window_conflicts(model, recipes, valid: torch.Tensor, *,
                     strict: bool = True,
                     backend: str | None = None) -> torch.Tensor:
    """Model-agnostic conflict matrix for one window: footprint models go
    through the conflict kernel, predicate-only models through the
    broadcast ``prefix_conflicts``. Both give the same [W, W] bool."""
    with annotate("protocol.conflict"):
        fp = model.task_footprint(recipes)
        if fp is not None:
            from repro_torch.kernels.conflict.ops import conflict_matrix

            read_ids, write_ids = fp
            return conflict_matrix(read_ids, write_ids, valid,
                                   strict=strict, backend=backend)
        return prefix_conflicts(model.conflicts, recipes, valid,
                                strict=strict)


def cross_window_conflicts(model, recipes_prev, valid_prev: torch.Tensor,
                           recipes_next, valid_next: torch.Tensor, *,
                           strict: bool = True,
                           backend: str | None = None) -> torch.Tensor:
    """Cross-window conflict block [W_next, W_prev] (bool).

    Row i = task i of the *later* window (k+1), column j = task j of the
    *earlier* window (k): C[i, j] iff next-task-i conflicts with
    prev-task-j. Every prev task precedes every next task in chain order,
    so the block is a full rectangle, masked by validity only.
    ``valid_prev`` doubles as the *alive* mask of window k's not-yet-
    drained tail: columns of already-executed tasks impose nothing.

    Footprint models go through the conflict kernel's block entry point;
    predicate-only models through the broadcast pairwise predicate.
    """
    with annotate("protocol.conflict_block"):
        fp_next = model.task_footprint(recipes_next)
        if fp_next is not None:
            from repro_torch.kernels.conflict.ops import conflict_block

            reads_n, writes_n = fp_next
            reads_p, writes_p = model.task_footprint(recipes_prev)
            return conflict_block(reads_n, writes_n, reads_p, writes_p,
                                  valid_next, valid_prev, strict=strict,
                                  backend=backend)
        rows = {k: x[:, None] for k, x in recipes_next.items()}
        cols = {k: x[None, :] for k, x in recipes_prev.items()}
        conf = model.conflicts(rows, cols, strict=strict)
        return conf & valid_next[:, None] & valid_prev[None, :]


def carry_frontier(cross: torch.Tensor,
                   levels_prev: torch.Tensor) -> torch.Tensor:
    """Per-task level floor imposed by the previous window's tail.

        carry[i] = max{ levels_prev[j] + 1 : cross[i, j] }   (else 0)

    ``levels_prev`` holds the previous window's *remaining* levels on the
    current level clock (-1 = already drained or padded), so a drained
    task contributes ``-1 + 1 = 0`` — no constraint. Fed to
    ``wave_levels(base=...)`` it pins every next-window task strictly
    after the tail waves it conflicts with. [W_next] int32.
    """
    with annotate("protocol.carry_frontier"):
        gated = torch.where(cross,
                            levels_prev.to(torch.int32)[None, :] + 1, 0)
        if gated.shape[1] == 0:
            return torch.zeros(gated.shape[0], dtype=torch.int32,
                               device=gated.device)
        return gated.amax(dim=1).to(torch.int32)


def wave_levels(conflicts: torch.Tensor, valid: torch.Tensor, *,
                base: torch.Tensor | None = None,
                backend: str | None = None) -> torch.Tensor:
    """DAG-level (wavefront) assignment.

        level[i] = max(base[i], 1 + max{ level[j] : j < i, C[i, j] })

    List scheduling with unbounded workers: a task enters level L only if
    every earlier conflicting task sits at a level < L, so executing the
    levels in ascending order is a topological order of the dependence
    DAG restricted to the window (paper §3.2). ``base`` is an optional
    non-negative per-task floor; invalid (padded) slots get level -1.
    """
    from repro_torch.kernels.levels.ops import wave_levels as _wave_levels

    with annotate("protocol.levels"):
        return _wave_levels(conflicts, valid, base=base, backend=backend)


def wave_levels_capped(conflicts, valid, n_workers: int) -> np.ndarray:
    """Finite-n list scheduling (NumPy, host-side): like wave_levels but each
    wave holds at most n_workers tasks; a task is placed in the earliest
    wave >= its dependence level that has spare capacity, scanning in chain
    order — n paper-workers with an ideal (zero-overhead) workflow."""
    conflicts = np.asarray(torch.as_tensor(conflicts).cpu())
    valid = np.asarray(torch.as_tensor(valid).cpu())
    w = conflicts.shape[0]
    levels = np.full(w, -1, dtype=np.int64)
    counts: dict[int, int] = {}
    for i in range(w):
        if not valid[i]:
            continue
        deps = np.nonzero(conflicts[i])[0]
        base = 0 if deps.size == 0 else int(levels[deps].max()) + 1
        lvl = base
        while counts.get(lvl, 0) >= n_workers:
            lvl += 1
        levels[i] = lvl
        counts[lvl] = counts.get(lvl, 0) + 1
    return levels


def critical_path_length(conflicts: torch.Tensor,
                         valid: torch.Tensor) -> int:
    """Longest dependence chain in the window (= #waves with n=inf)."""
    return int(wave_levels(conflicts, valid).max()) + 1

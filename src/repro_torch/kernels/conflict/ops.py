"""Public wrappers for the conflict computations: the prefix-conflict
matrix of one window and the cross-window block.

A CUDA tensor launches the hand-written kernel (conflict.py); a CPU
tensor takes the plain version (ref.py). ``backend`` forces one:
``"cuda"`` (the kernel — CUDA tensors only) or ``"torch"`` (the plain
version on the tensors' own device, as the kernel's parity checks use it).
``work`` is the kernels' work in bytes and operations, which the CUDA
branch reports to an installed cost recorder (``obs/costs.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.conflict.conflict import (
    conflict_block_cuda,
    conflict_matrix_cuda,
)
from repro_torch.kernels.conflict.ref import (
    conflict_block_ref,
    conflict_matrix_ref,
)
from repro_torch.obs.costs import current_recorder


def work(sides, out: torch.Tensor) -> tuple[int, float]:
    """(bytes, operations) the conflict kernels need on these inputs:
    every id slot and validity byte of each side in ``sides`` ((reads,
    writes, valid); one side for the prefix matrix, two for the block)
    and every byte of the output ``out``, once each; one operation per
    used slot of a valid task (its lookup or insert) and one per cell
    set. A join compares no slots that share no id. Data-dependent: it
    reads the device (a host sync)."""
    nbytes, ops = out.numel(), float(out.sum())
    for reads, writes, valid in sides:
        nbytes += 4 * (reads.numel() + writes.numel()) + valid.numel()
        ops += float(((reads >= 0).sum(1) + (writes >= 0).sum(1))[valid]
                     .sum())
    return nbytes, ops


def conflict_matrix(read_ids, write_ids, valid, *, strict: bool = True,
                    backend: str | None = None) -> torch.Tensor:
    """Prefix-conflict matrix [W, W] (bool) from id footprints.

    read_ids [W, nr] int32, write_ids [W, nw] int32; negative ids are
    unused slots; valid [W] bool masks padded window entries.
    """
    read_ids = read_ids.to(torch.int32).contiguous()
    write_ids = write_ids.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    if backend is None:
        backend = "cuda" if use_kernel(read_ids) else "torch"
    if backend == "cuda":
        out = conflict_matrix_cuda(read_ids, write_ids, valid,
                                   strict=strict)
        rec = current_recorder()
        if rec is not None:
            rec.kernel("conflict_matrix",
                       *work([(read_ids, write_ids, valid)], out))
        return out
    if backend == "torch":
        return conflict_matrix_ref(read_ids, write_ids, valid, strict=strict)
    raise ValueError(f"unknown conflict backend {backend!r}")


def conflict_block(reads_i, writes_i, reads_j, writes_j, valid_i, valid_j,
                   *, strict: bool = True,
                   backend: str | None = None) -> torch.Tensor:
    """Cross-window conflict block [Wi, Wj] (bool) from id footprints.

    Rows are the *later* window's tasks, columns the *earlier* window's;
    negative ids are unused slots; valid_i/valid_j mask padded entries.
    This is the overlapped engine's carry-over record check — the
    [W_next, W_tail] block between window k+1's tasks and window k's
    not-yet-drained tail (core/records.cross_window_conflicts).
    """
    reads_i, writes_i, reads_j, writes_j = (
        x.to(torch.int32).contiguous()
        for x in (reads_i, writes_i, reads_j, writes_j))
    valid_i = valid_i.to(torch.bool).contiguous()
    valid_j = valid_j.to(torch.bool).contiguous()
    if backend is None:
        backend = "cuda" if use_kernel(reads_i) else "torch"
    if backend == "cuda":
        out = conflict_block_cuda(reads_i, writes_i, reads_j, writes_j,
                                  valid_i, valid_j, strict=strict)
        rec = current_recorder()
        if rec is not None:
            rec.kernel("conflict_block", *work(
                [(reads_i, writes_i, valid_i), (reads_j, writes_j, valid_j)],
                out))
        return out
    if backend == "torch":
        return conflict_block_ref(reads_i, writes_i, reads_j, writes_j,
                                  valid_i, valid_j, strict=strict)
    raise ValueError(f"unknown conflict backend {backend!r}")

"""Public wrappers for the conflict computations: the prefix-conflict
matrix of one window and the cross-window block.

A CUDA tensor launches the hand-written kernel (conflict.py); a CPU
tensor takes the plain version (ref.py). ``backend`` forces one:
``"cuda"`` (the kernel — CUDA tensors only) or ``"torch"`` (the plain
version on the tensors' own device, as the kernel's parity checks use it).
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
        return conflict_matrix_cuda(read_ids, write_ids, valid,
                                    strict=strict)
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
        return conflict_block_cuda(reads_i, writes_i, reads_j, writes_j,
                                   valid_i, valid_j, strict=strict)
    if backend == "torch":
        return conflict_block_ref(reads_i, writes_i, reads_j, writes_j,
                                  valid_i, valid_j, strict=strict)
    raise ValueError(f"unknown conflict backend {backend!r}")

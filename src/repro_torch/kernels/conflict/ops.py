"""Public wrapper for the prefix-conflict computation.

A CUDA tensor launches the hand-written kernel (conflict.py); a CPU
tensor takes the plain version (ref.py). ``backend`` forces one:
``"cuda"`` (the kernel — CUDA tensors only) or ``"torch"`` (the plain
version on the tensors' own device, as the kernel's parity checks use it).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.conflict.conflict import conflict_matrix_cuda
from repro_torch.kernels.conflict.ref import conflict_matrix_ref


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

"""Public wrapper for Barabási–Albert attachment.

A CUDA tensor launches the hand-written kernel (attach.py); a CPU tensor
takes the plain version (ref.py). ``backend`` forces one: ``"cuda"`` (the
kernel — CUDA tensors only) or ``"torch"`` (the plain version on the
tensors' own device, as the kernel's parity checks use it).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.attach.attach import attach_cuda
from repro_torch.kernels.attach.ref import attach_plain


def attach_arrivals(key, ends, *, first: int, count: int, fill: int, m: int,
                    warm: int | None = None, block: int | None = None,
                    backend: str | None = None) -> torch.Tensor:
    """Targets [count, m] int32 of arrivals t = first .. first+count-1
    (i = t - first), each drawing m distinct nodes from ``ends[:span_i]``
    with the key ``fold_in(key, t)``: span_i = fill + 2m·i for the first
    ``warm`` arrivals (default all: the exact build), then fill +
    2m·(warm + block·⌊(i − warm)/block⌋), frozen blocks of ``block``
    (default one block of the rest). Each arrival's slab (its targets,
    then t repeated m times) is written into ``ends`` at fill + 2m·i.
    A whole build, exact or chunked, is one call.
    """
    if ends.dtype != torch.int32 or ends.dim() != 1:
        raise ValueError("ends must be a 1-d int32 tensor")
    key = key.to(device=ends.device, dtype=torch.int64).contiguous()
    if count == 0:
        return torch.empty((0, m), dtype=torch.int32, device=ends.device)
    if backend is None:
        backend = "cuda" if use_kernel(ends) else "torch"
    if backend == "cuda":
        return attach_cuda(key, ends, first=first, count=count, fill=fill,
                           m=m, warm=warm, block=block)
    if backend == "torch":
        return attach_plain(key, ends, first=first, count=count, fill=fill,
                            m=m, warm=warm, block=block)
    raise ValueError(f"unknown attach backend {backend!r}")

"""Public wrapper for Barabási–Albert attachment.

A CUDA tensor launches the hand-written kernel (attach.py); a CPU tensor
takes the plain version (ref.py). ``backend`` forces one: ``"cuda"`` (the
kernel — CUDA tensors only) or ``"torch"`` (the plain version on the
tensors' own device, as the kernel's parity checks use it). ``work`` is
the kernel's work in bytes and operations, which the CUDA branch reports
to an installed cost recorder (``obs/costs.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.attach.attach import attach_cuda
from repro_torch.kernels.attach import ref as attach_ref
from repro_torch.kernels.attach.ref import attach_plain
from repro_torch.obs.costs import current_recorder

#: ops of one Threefry-2x32 hash on the card: 20 mixing steps of an add, a
#: rotate and a xor, five key injections of three adds, the key's parity
#: word (two xors) and the first two adds
HASH_OPS = 79
#: ops of one rejection round: six hashes (the round's key — the fold_in
#: for the first, a split for the rest — its sub and randint's four), the
#: bits' two xors, three remainders (~15 ops each: a 32-bit division), a
#: multiply and an add
ROUND_OPS = 6 * HASH_OPS + 2 + 3 * 15 + 2
#: ops of an arrival besides its rounds: the multiplier's two remainders
ARRIVAL_OPS = 2 * 15


def work(count: int, m: int, rounds: int) -> tuple[int, int]:
    """(bytes, operations) of a build of ``count`` arrivals of ``m``
    targets whose draws took ``rounds`` rejection rounds (data-dependent:
    the plain version counts them, ``ref.rounds_drawn``): the key and the
    seed's ends read, every slab and target written; the rounds' and the
    arrivals' integer ops."""
    return (16 + 4 * (m + 1) * m + 12 * m * count,
            ARRIVAL_OPS * count + ROUND_OPS * rounds)


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
        rec = current_recorder()
        before = None if rec is None else ends.clone()
        out = attach_cuda(key, ends, first=first, count=count, fill=fill,
                          m=m, warm=warm, block=block)
        if rec is not None:
            # the rounds are the draws', which the plain version repeats
            r0 = attach_ref.rounds_drawn
            attach_plain(key, before, first=first, count=count, fill=fill,
                         m=m, warm=warm, block=block)
            rec.kernel("attach", *work(count, m,
                                       attach_ref.rounds_drawn - r0))
        return out
    if backend == "torch":
        return attach_plain(key, ends, first=first, count=count, fill=fill,
                            m=m, warm=warm, block=block)
    raise ValueError(f"unknown attach backend {backend!r}")

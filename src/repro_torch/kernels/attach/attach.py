"""Binding of the CUDA Barabási–Albert attachment kernel
(``csrc/attach.cu``).

Replaces no ``pallas_call``: it carries the reference's compiled
``lax.scan`` of arrivals (``repro/topology/generators.py:216-245``), which
eager PyTorch cannot. One launch resolves a whole build — the exact
warm-up and every frozen block — with one thread per arrival, each
waiting only for the earlier arrivals' targets it draws (see the
source's note for the design and what bounds it). The key is read on the
device, so a launch needs no host sync. ``launches`` counts the launches
of this wrapper; nothing else changes it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, check_tensor
from repro_torch.kernels.attach.ref import blocks

#: number of kernel launches made through ``attach_cuda``
launches = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("attach")
        lib.attach_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p])
        lib.attach_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def attach_cuda(key: torch.Tensor, ends: torch.Tensor, *, first: int,
                count: int, fill: int, m: int, warm: int | None = None,
                block: int | None = None) -> torch.Tensor:
    """key int64 [2], ends int32 [cap] (written in place), both
    contiguous on one CUDA device -> targets [count, m] int32; ``warm``
    and ``block`` as ``ops.attach_arrivals``."""
    global launches
    if ends.device.type != "cuda":
        raise ValueError("attach_cuda takes CUDA tensors; the plain version "
                         "is kernels/attach/ref.py")
    dev = ends.device
    check_tensor("key", key, torch.int64, (2,), dev)
    if ends.dim() != 1:
        raise ValueError(f"ends must be 1-d, got {tuple(ends.shape)}")
    check_tensor("ends", ends, torch.int32, tuple(ends.shape), dev)
    if count < 1 or m < 1 or fill < 1:
        raise ValueError(f"need count, m, fill >= 1: {count}, {m}, {fill}")
    warm, block = blocks(count, warm, block)
    end = fill + 2 * m * count
    if end > ends.shape[0] or end >= 1 << 31 or first + count > 1 << 31:
        raise ValueError(f"{count} arrivals from fill {fill} need {end} "
                         f"slots (< 2^31), ends has {ends.shape[0]}")
    lib = _load()
    out = torch.empty((count, m), dtype=torch.int32, device=dev)
    ticket = torch.empty(1, dtype=torch.int32, device=dev)  # zeroed there
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.attach_launch(key.data_ptr(), ends.data_ptr(),
                               out.data_ptr(), ticket.data_ptr(), first,
                               count, fill, m, warm, block, stream)
    if rc != 0:
        raise RuntimeError(f"attach kernel launch failed: CUDA error {rc}")
    launches += 1
    return out

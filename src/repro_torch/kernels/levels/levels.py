"""Binding of the CUDA wave-levels kernel (``csrc/levels.cu``).

Port of ``repro/kernels/levels/levels.py::wave_levels_pallas``: the level
recurrence over a [W, W] conflict matrix in one CTA, the level vector in
shared memory (see the source's note for the design and what bounds it).
``launches`` counts the launches of this wrapper; nothing else changes it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, check_tensor

#: number of kernel launches made through ``wave_levels_cuda``
launches = 0

#: largest window one launch takes (the level vector fits 48 KB of shared
#: memory); csrc/levels.cu checks the same bound
MAX_WINDOW = 8192

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("levels")
        lib.wave_levels_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.wave_levels_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def wave_levels_cuda(conflicts: torch.Tensor, valid: torch.Tensor,
                     base: torch.Tensor | None = None) -> torch.Tensor:
    """conflicts [W, W] bool, valid [W] bool, base [W] int32 or None, all
    contiguous on one CUDA device -> [W] int32 levels."""
    global launches
    if conflicts.device.type != "cuda":
        raise ValueError("wave_levels_cuda takes CUDA tensors; the plain "
                         "version is kernels/levels/ref.py")
    if conflicts.dim() != 2 or conflicts.shape[0] != conflicts.shape[1]:
        raise ValueError(f"conflicts must be [W, W], got "
                         f"{tuple(conflicts.shape)}")
    w = conflicts.shape[0]
    if not 1 <= w <= MAX_WINDOW:
        raise ValueError(f"window {w} outside the kernel's 1..{MAX_WINDOW}")
    dev = conflicts.device
    check_tensor("conflicts", conflicts, torch.bool, (w, w), dev)
    check_tensor("valid", valid, torch.bool, (w,), dev)
    if base is not None:
        check_tensor("base", base, torch.int32, (w,), dev)
    lib = _load()
    out = torch.empty((w,), dtype=torch.int32, device=dev)
    vec = int(w % 16 == 0 and conflicts.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wave_levels_launch(
            conflicts.data_ptr(), valid.data_ptr(),
            None if base is None else base.data_ptr(), out.data_ptr(), w,
            vec, stream)
    if rc != 0:
        raise RuntimeError(f"wave_levels kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return out

"""Binding of the CUDA wave-levels kernel (``csrc/levels.cu``).

Port of ``repro/kernels/levels/levels.py::wave_levels_pallas``: the level
recurrence over a [W, W] conflict matrix, for any W. One cooperative
launch relaxes the levels to their fixed point on every SM — a first pass
packs the matrix below the diagonal into a bitmap, each further pass
applies the recurrence to every row at once, and a pass that changes
nothing ends it — and, after 8 passes without convergence (the source's
``MAX_PASSES``), finishes with the exact blocked sweep in one CTA (see the
source's note for the design and what bounds it). The wrapper allocates
the bitmap and the pass flags as scratch, and a 2-word tensor for the
launch's [passes, swept] (``torch.empty``): one launch per call.
``launches`` counts the launches of this wrapper; nothing else changes it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, check_tensor

#: number of kernel launches made through ``wave_levels_cuda``
launches = 0

_lib = None
_info = None  # the last launch's [passes, swept] on the device


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("levels")
        lib.wave_levels_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.wave_levels_launch.restype = ctypes.c_int
        lib.wave_levels_scratch_words.argtypes = [ctypes.c_int]
        lib.wave_levels_scratch_words.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def last_run() -> tuple[int, bool]:
    """(passes, swept) of the last launch: the passes it ran (the last one
    changed nothing unless it swept) and whether the blocked sweep
    finished it. Reads the device (a host sync); for diagnostics."""
    if _info is None:
        raise RuntimeError("wave_levels_cuda has not run")
    passes, swept = _info.tolist()
    return passes, bool(swept)


def wave_levels_cuda(conflicts: torch.Tensor, valid: torch.Tensor,
                     base: torch.Tensor | None = None) -> torch.Tensor:
    """conflicts [W, W] bool, valid [W] bool, base [W] int32 or None, all
    contiguous on one CUDA device -> [W] int32 levels."""
    global launches, _info
    if conflicts.device.type != "cuda":
        raise ValueError("wave_levels_cuda takes CUDA tensors; the plain "
                         "version is kernels/levels/ref.py")
    if conflicts.dim() != 2 or conflicts.shape[0] != conflicts.shape[1]:
        raise ValueError(f"conflicts must be [W, W], got "
                         f"{tuple(conflicts.shape)}")
    w = conflicts.shape[0]
    if w == 0:
        raise ValueError("empty window")
    dev = conflicts.device
    check_tensor("conflicts", conflicts, torch.bool, (w, w), dev)
    check_tensor("valid", valid, torch.bool, (w,), dev)
    if base is not None:
        check_tensor("base", base, torch.int32, (w,), dev)
    lib = _load()
    out = torch.empty((w,), dtype=torch.int32, device=dev)
    # the bitmap and the pass flags, freed with the call
    scratch = torch.empty((lib.wave_levels_scratch_words(w),),
                          dtype=torch.int32, device=dev)
    info = torch.empty((2,), dtype=torch.int32, device=dev)
    vec = int(w % 16 == 0 and conflicts.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wave_levels_launch(
            conflicts.data_ptr(), valid.data_ptr(),
            None if base is None else base.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), info.data_ptr(), w, vec, stream)
    if rc != 0:
        raise RuntimeError(f"wave_levels kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    _info = info
    return out

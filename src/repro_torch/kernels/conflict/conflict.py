"""Binding of the CUDA prefix-conflict kernel (``csrc/conflict.cu``).

Port of ``repro/kernels/conflict/conflict.py::conflict_matrix_pallas``:
the [W, W] strictly-lower-triangular prefix-conflict matrix from task id
footprints, one 32×32 CTA per output tile (see the source's note for the
design and what bounds it). ``launches`` counts the launches of this
wrapper; nothing else changes it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, check_tensor

#: number of kernel launches made through ``conflict_matrix_cuda``
launches = 0

_SMEM_LIMIT = 48 * 1024
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("conflict")
        lib.conflict_matrix_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.conflict_matrix_launch.restype = ctypes.c_int
        lib.conflict_matrix_smem_bytes.argtypes = [ctypes.c_int,
                                                   ctypes.c_int]
        lib.conflict_matrix_smem_bytes.restype = ctypes.c_int
        _lib = lib
    return _lib


def conflict_matrix_cuda(read_ids: torch.Tensor, write_ids: torch.Tensor,
                         valid: torch.Tensor, *,
                         strict: bool = True) -> torch.Tensor:
    """read_ids [W, nr] int32, write_ids [W, nw] int32 (-1 = unused slot),
    valid [W] bool, all contiguous on one CUDA device -> [W, W] bool."""
    global launches
    if read_ids.device.type != "cuda":
        raise ValueError("conflict_matrix_cuda takes CUDA tensors; the "
                         "plain version is kernels/conflict/ref.py")
    if read_ids.dim() != 2 or write_ids.dim() != 2:
        raise ValueError("read_ids and write_ids must be [W, n] tensors")
    w, nr = read_ids.shape
    nw = write_ids.shape[1]
    if w == 0 or nr == 0 or nw == 0:
        raise ValueError(f"empty footprint: W={w}, nr={nr}, nw={nw}")
    dev = read_ids.device
    check_tensor("read_ids", read_ids, torch.int32, (w, nr), dev)
    check_tensor("write_ids", write_ids, torch.int32, (w, nw), dev)
    check_tensor("valid", valid, torch.bool, (w,), dev)
    lib = _load()
    if lib.conflict_matrix_smem_bytes(nr, nw) > _SMEM_LIMIT:
        raise ValueError(f"footprint too wide for one tile's shared "
                         f"memory: nr={nr}, nw={nw}")
    out = torch.empty((w, w), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.conflict_matrix_launch(
            read_ids.data_ptr(), write_ids.data_ptr(), valid.data_ptr(),
            out.data_ptr(), w, nr, nw, int(strict), stream)
    if rc != 0:
        raise RuntimeError(f"conflict_matrix kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out

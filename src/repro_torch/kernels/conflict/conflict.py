"""Bindings of the CUDA conflict kernels (``csrc/conflict.cu``).

Ports of ``repro/kernels/conflict/conflict.py``, one 32×32 CTA per output
tile, at any footprint width (see the source's note for the design and
what bounds it):

  conflict_matrix_cuda  ``conflict_matrix_pallas``: the [W, W] strictly-
                        lower-triangular prefix-conflict matrix of one
                        window; counted by ``launches``
  conflict_block_cuda   ``conflict_block_pallas``: the [Wi, Wj] cross-
                        window block (later window's rows, earlier
                        window's columns, validity mask only); counted by
                        ``block_launches``

A footprint whose slots fit one stage of shared memory takes the narrow
kernel, which stages every slot at once; a wider one takes the chunked
kernel, ``staging_chunks`` slots a pass. Each counter changes only where
its wrapper launches its kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, check_tensor

#: number of kernel launches made through ``conflict_matrix_cuda``
launches = 0
#: number of kernel launches made through ``conflict_block_cuda``
block_launches = 0

#: id slots a tile stages per side and pass: 48 KB of shared memory hold
#: two sides of 32 rows x 192 slots of 4 bytes (csrc/conflict.cu checks it)
STAGE_SLOTS = 192

_lib = None


def staging_chunks(nr_i: int, nw_i: int, nr_j: int,
                   nw_j: int) -> tuple[int, int]:
    """(kr, kw): the read and write slots of each side that one pass of
    the chunked kernel stages, or (0, 0) when both sides' whole footprints
    fit one stage (the narrow kernel)."""
    if nr_i + nw_i + nr_j + nw_j <= 2 * STAGE_SLOTS:
        return 0, 0
    kw = min(max(nw_i, nw_j), STAGE_SLOTS // 2)
    return min(max(nr_i, nr_j), STAGE_SLOTS - kw), kw


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("conflict")
        lib.conflict_matrix_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.conflict_matrix_launch.restype = ctypes.c_int
        lib.conflict_block_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        lib.conflict_block_launch.restype = ctypes.c_int
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
    kr, kw = staging_chunks(nr, nw, nr, nw)
    out = torch.empty((w, w), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.conflict_matrix_launch(
            read_ids.data_ptr(), write_ids.data_ptr(), valid.data_ptr(),
            out.data_ptr(), w, nr, nw, int(strict), kr, kw, stream)
    if rc != 0:
        raise RuntimeError(f"conflict_matrix kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out


def conflict_block_cuda(reads_i: torch.Tensor, writes_i: torch.Tensor,
                        reads_j: torch.Tensor, writes_j: torch.Tensor,
                        valid_i: torch.Tensor, valid_j: torch.Tensor, *,
                        strict: bool = True) -> torch.Tensor:
    """reads_i [Wi, nr_i], writes_i [Wi, nw_i], reads_j [Wj, nr_j],
    writes_j [Wj, nw_j] int32 (-1 = unused slot), valid_i [Wi], valid_j
    [Wj] bool, all contiguous on one CUDA device -> [Wi, Wj] bool."""
    global block_launches
    if reads_i.device.type != "cuda":
        raise ValueError("conflict_block_cuda takes CUDA tensors; the "
                         "plain version is kernels/conflict/ref.py")
    for name, t in (("reads_i", reads_i), ("writes_i", writes_i),
                    ("reads_j", reads_j), ("writes_j", writes_j)):
        if t.dim() != 2:
            raise ValueError(f"{name} must be a [W, n] tensor")
    wi, nr_i = reads_i.shape
    wj, nr_j = reads_j.shape
    nw_i, nw_j = writes_i.shape[1], writes_j.shape[1]
    if 0 in (wi, wj, nr_i, nw_i, nr_j, nw_j):
        raise ValueError(f"empty footprint: Wi={wi}, Wj={wj}, nr_i={nr_i}, "
                         f"nw_i={nw_i}, nr_j={nr_j}, nw_j={nw_j}")
    dev = reads_i.device
    check_tensor("reads_i", reads_i, torch.int32, (wi, nr_i), dev)
    check_tensor("writes_i", writes_i, torch.int32, (wi, nw_i), dev)
    check_tensor("reads_j", reads_j, torch.int32, (wj, nr_j), dev)
    check_tensor("writes_j", writes_j, torch.int32, (wj, nw_j), dev)
    check_tensor("valid_i", valid_i, torch.bool, (wi,), dev)
    check_tensor("valid_j", valid_j, torch.bool, (wj,), dev)
    lib = _load()
    kr, kw = staging_chunks(nr_i, nw_i, nr_j, nw_j)
    out = torch.empty((wi, wj), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.conflict_block_launch(
            reads_i.data_ptr(), writes_i.data_ptr(), reads_j.data_ptr(),
            writes_j.data_ptr(), valid_i.data_ptr(), valid_j.data_ptr(),
            out.data_ptr(), wi, wj, nr_i, nw_i, nr_j, nw_j, int(strict), kr,
            kw, stream)
    if rc != 0:
        raise RuntimeError(f"conflict_block kernel launch failed: CUDA "
                           f"error {rc}")
    block_launches += 1
    return out

"""Bindings of the CUDA conflict kernels (``csrc/conflict.cu``).

Ports of ``repro/kernels/conflict/conflict.py``, one cooperative launch
per call at any footprint width and any window (see the source's note for
the design and what bounds it): the output is zero-filled, the write ids
go into hash tables, and each used id slot looks up the tasks that share
its id.

  conflict_matrix_cuda  ``conflict_matrix_pallas``: the [W, W] strictly-
                        lower-triangular prefix-conflict matrix of one
                        window; counted by ``launches``
  conflict_block_cuda   ``conflict_block_pallas``: the [Wi, Wj] cross-
                        window block (later window's rows, earlier
                        window's columns, validity mask only); counted by
                        ``block_launches``

The wrappers size the tables from the shapes alone (``table_slots``) and
allocate them as scratch with ``torch.empty``: nothing is read back, so a
call adds no host sync. Each counter changes only where its wrapper
launches its kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, check_tensor

#: number of kernel launches made through ``conflict_matrix_cuda``
launches = 0
#: number of kernel launches made through ``conflict_block_cuda``
block_launches = 0

#: scratch bytes per table slot: a bucket's key (8 bytes), its 8 task
#: indices and an id's count (4 bytes each); and of the scratch's header,
#: which precedes the tables (csrc/conflict.cu checks both)
TABLE_SLOT_BYTES = 44
SCRATCH_HEADER_BYTES = 32

_lib = None


def table_slots(w: int, nw: int) -> int:
    """Slots of the hash table of one side's write ids: the least power of
    two of at least 8·w·nw, so at most an eighth of them is taken and the
    walks of the kernel's linear probing stay short."""
    return 1 << (8 * w * nw - 1).bit_length()


def scratch_bytes(*slots: int) -> int:
    """Bytes of the kernel's scratch for tables of these slots."""
    return SCRATCH_HEADER_BYTES + sum(slots) * TABLE_SLOT_BYTES


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("conflict")
        lib.conflict_matrix_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
            + [ctypes.c_longlong, ctypes.c_void_p])
        lib.conflict_matrix_launch.restype = ctypes.c_int
        lib.conflict_block_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
            + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
        lib.conflict_block_launch.restype = ctypes.c_int
        lib.conflict_table_slot_bytes.restype = ctypes.c_longlong
        lib.conflict_scratch_header_bytes.restype = ctypes.c_longlong
        if (lib.conflict_table_slot_bytes() != TABLE_SLOT_BYTES
                or lib.conflict_scratch_header_bytes()
                != SCRATCH_HEADER_BYTES):
            raise RuntimeError("csrc/conflict.cu's scratch layout does not "
                               "match TABLE_SLOT_BYTES and "
                               "SCRATCH_HEADER_BYTES")
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
    slots = table_slots(w, nw)
    out = torch.empty((w, w), dtype=torch.bool, device=dev)
    scratch = torch.empty((scratch_bytes(slots),), dtype=torch.uint8,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.conflict_matrix_launch(
            read_ids.data_ptr(), write_ids.data_ptr(), valid.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), w, nr, nw, int(strict),
            slots, stream)
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
    # the row side's table serves the anti hazard, under the strict rule
    slots_j = table_slots(wj, nw_j)
    slots_i = table_slots(wi, nw_i) if strict else 0
    out = torch.empty((wi, wj), dtype=torch.bool, device=dev)
    scratch = torch.empty((scratch_bytes(slots_j, slots_i),),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.conflict_block_launch(
            reads_i.data_ptr(), writes_i.data_ptr(), reads_j.data_ptr(),
            writes_j.data_ptr(), valid_i.data_ptr(), valid_j.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), wi, wj, nr_i, nw_i, nr_j,
            nw_j, int(strict), slots_i, slots_j, stream)
    if rc != 0:
        raise RuntimeError(f"conflict_block kernel launch failed: CUDA "
                           f"error {rc}")
    block_launches += 1
    return out

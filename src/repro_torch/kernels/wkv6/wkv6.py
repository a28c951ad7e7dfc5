"""Binding of the CUDA WKV6 kernel (``csrc/wkv6.cu``).

Port of ``repro/kernels/wkv6/wkv6.py::wkv6_pallas``: the RWKV6 time-mix
recurrence with data-dependent decay, float32 state, returning the
outputs and the final state (see the source's note for the design and
what bounds it). Unlike the TPU kernel it takes an initial state and any
T >= 1: the serving path's chunked prefill carries a state and ends in a
ragged chunk, and a decode step has T = 1. The final state may be written
into a given tensor — ``s0`` itself included — and, under a ``commit``
mask, only into the committed batch rows. ``launches`` counts the
launches of this wrapper; nothing else changes it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, check_tensor

#: number of kernel launches made through ``wkv6_cuda``
launches = 0

#: widest head the kernel takes (a thread per value column); csrc/wkv6.cu
#: checks the same bound
MAX_HEAD_DIM = 128

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("wkv6")
        lib.wkv6_launch.argtypes = ([ctypes.c_void_p] * 9
                                    + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.wkv6_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, *, n_heads: int,
              s0: torch.Tensor | None = None,
              s_out: torch.Tensor | None = None,
              commit: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w [B·H, T, D], float32 or bfloat16, one dtype; u [H, D]
    float32 (row b·H + h uses ``u[h]``); s0 (optional) [B·H, D, D]
    float32; s_out (optional) [B·H, D, D] float32, the final state's
    destination, which may be ``s0``; commit (optional, with s_out) [B]
    bool: only those batch rows' final states are written, the other rows
    of s_out are left as they are. All contiguous on one CUDA device;
    T >= 1, D <= 128. Returns (o [B·H, T, D], s_final [B·H, D, D]),
    float32; s_final is s_out when one is given."""
    global launches
    if r.device.type != "cuda":
        raise ValueError("wkv6_cuda takes CUDA tensors; the plain version "
                         "is kernels/wkv6/ref.py")
    if r.dim() != 3:
        raise ValueError(f"r must be 3-d [B·H, T, D], got {tuple(r.shape)}")
    bh, t, d = r.shape
    if r.dtype not in _DTYPES:
        raise TypeError(f"wkv6 kernel takes float32 or bfloat16, got "
                        f"{r.dtype}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside the kernel's "
                         f"1..{MAX_HEAD_DIM}")
    if t < 1:
        raise ValueError("the kernel takes T >= 1")
    if n_heads <= 0 or bh % n_heads:
        raise ValueError(f"heads do not match: {bh} rows of H={n_heads}")
    dev = r.device
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w)):
        check_tensor(name, x, r.dtype, (bh, t, d), dev)
    check_tensor("u", u, torch.float32, (n_heads, d), dev)
    if s0 is not None:
        check_tensor("s0", s0, torch.float32, (bh, d, d), dev)
    if s_out is not None:
        check_tensor("s_out", s_out, torch.float32, (bh, d, d), dev)
    if commit is not None:
        if s_out is None:
            raise ValueError("commit needs s_out: it names the rows of "
                             "s_out to write")
        check_tensor("commit", commit, torch.bool, (bh // n_heads,), dev)
    o = torch.empty((bh, t, d), dtype=torch.float32, device=dev)
    s_final = (torch.empty((bh, d, d), dtype=torch.float32, device=dev)
               if s_out is None else s_out)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            o.data_ptr(), s_final.data_ptr(),
            None if commit is None else commit.data_ptr(), bh, n_heads, t,
            d, _DTYPES[r.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {rc}")
    launches += 1
    return o, s_final

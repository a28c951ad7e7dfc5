"""Binding of the CUDA Axelrod wave kernel (``csrc/axelrod.cu``).

Port of ``repro/kernels/axelrod/axelrod.py::axelrod_wave_pallas``: one
warp per task row, features strided over the lanes, the overlap count
and the first-maximum feature pick reduced with warp shuffles (see the
source's note for the design and what bounds it). ``launches`` counts
the launches of this wrapper; nothing else changes it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, check_tensor

#: number of kernel launches made through ``axelrod_wave_cuda``
launches = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("axelrod")
        lib.axelrod_wave_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_void_p])
        lib.axelrod_wave_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def axelrod_wave_cuda(s_tr: torch.Tensor, t_tr: torch.Tensor,
                      u: torch.Tensor, gumbel: torch.Tensor,
                      mask: torch.Tensor, *,
                      omega: float) -> tuple[torch.Tensor, torch.Tensor]:
    """s_tr, t_tr [W, F] int32, u [W] float32, gumbel [W, F] float32,
    mask [W] bool, all contiguous on one CUDA device -> (new_t [W, F]
    int32, interact [W] bool)."""
    global launches
    if s_tr.device.type != "cuda":
        raise ValueError("axelrod_wave_cuda takes CUDA tensors; the plain "
                         "version is kernels/axelrod/ref.py")
    if s_tr.dim() != 2:
        raise ValueError(f"s_tr must be [W, F], got {tuple(s_tr.shape)}")
    w, f = s_tr.shape
    if w == 0 or f == 0:
        raise ValueError(f"empty wave: W={w}, F={f}")
    dev = s_tr.device
    check_tensor("s_tr", s_tr, torch.int32, (w, f), dev)
    check_tensor("t_tr", t_tr, torch.int32, (w, f), dev)
    check_tensor("u", u, torch.float32, (w,), dev)
    check_tensor("gumbel", gumbel, torch.float32, (w, f), dev)
    check_tensor("mask", mask, torch.bool, (w,), dev)
    lib = _load()
    new_t = torch.empty((w, f), dtype=torch.int32, device=dev)
    interact = torch.empty((w,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # ctypes rounds the double 1 - omega to float32 to nearest, as
        # jnp rounds its weak-typed scalar
        rc = lib.axelrod_wave_launch(
            s_tr.data_ptr(), t_tr.data_ptr(), u.data_ptr(),
            gumbel.data_ptr(), mask.data_ptr(), new_t.data_ptr(),
            interact.data_ptr(), w, f, 1.0 - omega, stream)
    if rc != 0:
        raise RuntimeError(f"axelrod_wave kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return new_t, interact

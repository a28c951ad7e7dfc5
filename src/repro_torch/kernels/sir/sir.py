"""Binding of the CUDA SIRS wave kernel (``csrc/sir.cu``).

Port of ``repro/kernels/sir/sir.py::sir_wave_pallas`` together with its
wrapper's halo gather: rows packed by subset size, each row's threads
stage the ring halo of its subset in shared memory and update 4 or 16
consecutive agents each with a sliding neighbour count (see the source's
note for the design and what bounds it). ``launches`` counts the launches
of this wrapper; nothing else changes it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, check_tensor

#: number of kernel launches made through ``sir_wave_cuda``
launches = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("sir")
        lib.sir_wave_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
            + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        lib.sir_wave_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def sir_wave_cuda(states: torch.Tensor, subsets: torch.Tensor,
                  u: torch.Tensor, *, k: int, p_si: float, p_ir: float,
                  p_rs: float) -> torch.Tensor:
    """states [N] int8, subsets [W] int32, u [W, s] float32, all
    contiguous on one CUDA device; s + k <= N -> [W, s] int8 next
    states."""
    global launches
    if states.device.type != "cuda":
        raise ValueError("sir_wave_cuda takes CUDA tensors; the plain "
                         "version is kernels/sir/ref.py")
    if u.dim() != 2:
        raise ValueError(f"u must be [W, s], got {tuple(u.shape)}")
    w, s = u.shape
    n = states.shape[0] if states.dim() == 1 else -1
    if w == 0 or s == 0 or k <= 0:
        raise ValueError(f"empty wave: W={w}, s={s}, k={k}")
    if s + k > n:
        raise ValueError(f"the ring halo needs s + k <= N: s={s}, k={k}, "
                         f"N={n}")
    dev = states.device
    check_tensor("states", states, torch.int8, (n,), dev)
    check_tensor("subsets", subsets, torch.int32, (w,), dev)
    check_tensor("u", u, torch.float32, (w, s), dev)
    lib = _load()
    out = torch.empty((w, s), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # ctypes rounds the double rates to float32 to nearest, as jnp
        # rounds its weak-typed scalars
        rc = lib.sir_wave_launch(
            states.data_ptr(), subsets.data_ptr(), u.data_ptr(),
            out.data_ptr(), w, n, s, k, p_si, p_ir, p_rs, stream)
    if rc != 0:
        raise RuntimeError(f"sir_wave kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return out

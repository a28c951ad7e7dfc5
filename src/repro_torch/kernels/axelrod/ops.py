"""Public wrapper for one Axelrod wave on gathered trait rows (the gather
and the scatter stay with the caller, as in the reference).

A CUDA tensor launches the hand-written kernel (axelrod.py); a CPU tensor
takes the plain version (ref.py). ``backend`` forces one: ``"cuda"`` (the
kernel — CUDA tensors only) or ``"torch"`` (the plain version on the
tensors' own device, as the kernel's parity checks use it).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.axelrod.axelrod import axelrod_wave_cuda
from repro_torch.kernels.axelrod.ref import axelrod_wave_ref


def axelrod_wave(s_tr, t_tr, u, gumbel, mask, *, omega: float,
                 backend: str | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One wave of pairwise interactions. Returns (new_t [W, F] int32,
    interact [W] bool).

    s_tr, t_tr [W, F] (source / target traits), u [W] float32, gumbel
    [W, F] float32, mask [W] bool; unpadded (any W, F >= 1).
    """
    s_tr = s_tr.to(torch.int32).contiguous()
    t_tr = t_tr.to(torch.int32).contiguous()
    u = u.to(torch.float32).contiguous()
    gumbel = gumbel.to(torch.float32).contiguous()
    mask = mask.to(torch.bool).contiguous()
    if backend is None:
        backend = "cuda" if use_kernel(s_tr) else "torch"
    if backend == "cuda":
        return axelrod_wave_cuda(s_tr, t_tr, u, gumbel, mask, omega=omega)
    if backend == "torch":
        return axelrod_wave_ref(s_tr, t_tr, u, gumbel, mask, omega=omega,
                                n_features=s_tr.shape[1])
    raise ValueError(f"unknown axelrod backend {backend!r}")

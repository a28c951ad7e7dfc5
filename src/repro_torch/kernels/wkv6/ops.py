"""Public wrapper for the WKV6 recurrence, and the O(1) decode step.

A CUDA tensor launches the hand-written kernel (wkv6.py, the port of
``repro/kernels/wkv6/ops.py::wkv6``); a CPU tensor takes the plain
version (ref.py). There is no other path. Neither has a backward: with
grad enabled and an input that requires grad, the call raises on either
device (``kernels.refuse_grad``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import refuse_grad, use_kernel
from repro_torch.kernels.wkv6.ref import (
    check_commit,
    wkv6_decode_step,
    wkv6_ref,
)
from repro_torch.kernels.wkv6.wkv6 import wkv6_cuda

__all__ = ["wkv6", "wkv6_decode_step"]


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, *, s0: torch.Tensor | None = None,
         s_out: torch.Tensor | None = None,
         commit: torch.Tensor | None = None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 time-mix. r/k/v/w [B, H, T, D]; u [H, D]; s0 (optional)
    [B, H, D, D], the state carried in; s_out (optional) [B, H, D, D]
    float32 (contiguous on the card), where the final state goes — ``s0``
    itself for an in-place update; commit (optional, with s_out) [B]
    bool, the batch rows whose final state is written (the others of
    s_out stay as they are).

    Returns (o [B, H, T, D] f32, s_final [B, H, D, D] f32), s_final being
    s_out when one is given. Any T >= 1 (the reference's kernel wrapper
    needs a multiple of 32). One kernel launch on CUDA tensors.
    """
    refuse_grad("wkv6", r, k, v, w, u, s0)
    if not use_kernel(r):
        return wkv6_ref(r, k, v, w, u, s0=s0, s_out=s_out, commit=commit)
    check_commit(s_out, commit)
    b, h, t, d = r.shape
    flat = lambda x: x.reshape(b * h, t, d).contiguous()  # noqa: E731
    s_fin = (torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
             if s_out is None else s_out)
    o, _ = wkv6_cuda(
        flat(r), flat(k), flat(v), flat(w), u.float().contiguous(),
        n_heads=h,
        s0=None if s0 is None else s0.float().reshape(b * h, d, d)
        .contiguous(),
        s_out=s_fin.view(b * h, d, d),
        commit=None if commit is None else commit.contiguous())
    return o.reshape(b, h, t, d), s_fin

"""Public wrapper for fused attention.

A CUDA tensor launches the hand-written kernel (flash.py, the port of
``repro/kernels/flash/ops.py::flash_attention``); a CPU tensor takes the
plain version (ref.py). There is no other path. Neither has a backward:
with grad enabled and an input that requires grad, the call raises on
either device (``kernels.refuse_grad``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import refuse_grad, use_kernel
from repro_torch.kernels.flash.flash import (
    check_masked_rows,
    flash_attention_cuda,
)
from repro_torch.kernels.flash.ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q [B, H, T, D]; k, v [B, Hkv, S, D] (GQA via H % Hkv == 0).

    Sliding ``window`` w: query t attends keys (t-w, t]; requires causal.
    Ends are aligned when S > T (chunked prefill semantics). T > S is
    taken without a mask (cross-attention); with one it raises on either
    device, as the kernel's binding does.
    """
    refuse_grad("flash_attention", q, k, v)
    b, h, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    check_masked_rows(t, s, causal, window)
    if scale is None:
        scale = float(d) ** -0.5
    if not use_kernel(q):
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale)
    o = flash_attention_cuda(
        q.reshape(b * h, t, d).contiguous(),
        k.reshape(b * hkv, s, d).contiguous(),
        v.reshape(b * hkv, s, d).contiguous(),
        n_q_heads=h, n_kv_heads=hkv, causal=causal, window=window,
        scale=scale)
    return o.reshape(b, h, t, d)

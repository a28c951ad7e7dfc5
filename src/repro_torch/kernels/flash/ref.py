"""Plain PyTorch version of fused attention (causal / sliding-window /
full), the port of ``repro/kernels/flash/ref.py::attention_ref``."""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """q [B, H, T, D]; k, v [B, Hkv, S, D] with H % Hkv == 0 (GQA).

    window w: query t attends to keys in (t-w, t] (requires causal).
    When S > T the query block is aligned to the *end* of the key axis
    (chunked prefill / decode semantics); T > S without a mask is plain
    cross-attention. A row that sees no key (T > S under a causal mask or
    a window) comes out NaN: the kernel's wrapper refuses those shapes.
    Returns [B, H, T, D] in q's dtype; softmax accumulates in float32.
    """
    b, h, t, d = q.shape
    hkv = k.shape[1]
    group = h // hkv
    if scale is None:
        scale = d ** -0.5

    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)

    logits = torch.einsum("bhtd,bhsd->bhts", q.float(), kk.float()) * scale
    s = kk.shape[2]
    qi = torch.arange(t, device=q.device)[:, None] + (s - t)  # align ends
    ki = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhts,bhsd->bhtd", p, vv.float())
    return out.to(q.dtype)

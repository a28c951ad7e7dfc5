"""Plain PyTorch version of the RWKV6 (Finch) time-mix recurrence, the
port of ``repro/kernels/wkv6/ref.py::wkv6_ref`` and of the one-token step
``repro/kernels/wkv6/ops.py::wkv6_decode_step``.

Per head with state S ∈ R^{D×D} (key-dim × value-dim), data-dependent
per-channel decay w_t ∈ (0,1)^D and bonus u ∈ R^D:

    o_t = r_t @ S  +  (Σ_d r_t[d]·u[d]·k_t[d]) · v_t
    S  <- diag(w_t) @ S + k_t ⊗ v_t

The reference scans the steps per head under two ``vmap``s; here one
Python loop over T is vectorised over [B, H], in float32 throughout.
"""
from __future__ import annotations

import torch


def wkv6_decode_step(s, r, k, v, w, u):
    """One-token recurrence. s [B, H, D, D]; r/k/v/w [B, H, D]; u [H, D].
    Returns (o [B, H, D] f32, s_next [B, H, D, D] f32)."""
    sf = s.float()
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()
    bonus = (rf * uf[None] * kf).sum(dim=-1, keepdim=True)      # [B, H, 1]
    o = torch.einsum("bhk,bhkd->bhd", rf, sf) + bonus * vf
    s_next = wf[..., None] * sf + kf[..., None] * vf[..., None, :]
    return o, s_next


def wkv6_ref(r, k, v, w, u, *, s0=None):
    """r, k, v, w: [B, H, T, D]; u: [H, D]; s0 (optional) [B, H, D, D].

    Returns (o [B, H, T, D] f32, s_final [B, H, D, D] f32).
    """
    b, h, t, d = r.shape
    if s0 is None:
        s = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    else:
        s = s0.float()
    o = torch.empty((b, h, t, d), dtype=torch.float32, device=r.device)
    for i in range(t):
        o[:, :, i], s = wkv6_decode_step(s, r[:, :, i], k[:, :, i],
                                         v[:, :, i], w[:, :, i], u)
    return o, s

"""Plain PyTorch version of the RWKV6 (Finch) time-mix recurrence, the
port of ``repro/kernels/wkv6/ref.py::wkv6_ref`` and of the one-token step
``repro/kernels/wkv6/ops.py::wkv6_decode_step``.

Per head with state S ∈ R^{D×D} (key-dim × value-dim), data-dependent
per-channel decay w_t ∈ (0,1)^D and bonus u ∈ R^D:

    o_t = r_t @ S  +  (Σ_d r_t[d]·u[d]·k_t[d]) · v_t
    S  <- diag(w_t) @ S + k_t ⊗ v_t

The reference scans the steps per head under two ``vmap``s; here one
Python loop over T is vectorised over [B, H], in float32 throughout.

Unlike the reference, which returns a new state, ``wkv6_ref`` may write
the final state into a given tensor ``s_out`` (``s0`` itself included),
and under a ``commit`` mask ([B] bool) only into the committed batch
rows: the serving engine's masked, in-place state update. The CUDA
kernel keeps the same contract.
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


def write_state(s_out: torch.Tensor, s: torch.Tensor,
                commit: torch.Tensor | None) -> torch.Tensor:
    """``s_out`` <- ``s`` in place ([B, ...] float32); with ``commit`` ([B]
    bool) only the committed rows, the others keep their values. Returns
    ``s_out``."""
    if s_out.dtype != torch.float32:
        raise TypeError(f"s_out has dtype {s_out.dtype}, expected "
                        f"torch.float32")
    if s_out.shape != s.shape:
        raise ValueError(f"s_out has shape {tuple(s_out.shape)}, expected "
                         f"{tuple(s.shape)}")
    if commit is not None:
        s = torch.where(commit.view((-1,) + (1,) * (s.dim() - 1)), s, s_out)
    return s_out.copy_(s)


def check_commit(s_out, commit) -> None:
    """A ``commit`` mask names rows of ``s_out``: it needs one."""
    if commit is not None and s_out is None:
        raise ValueError("commit needs s_out: it names the rows of s_out "
                         "to write")


def wkv6_ref(r, k, v, w, u, *, s0=None, s_out=None, commit=None):
    """r, k, v, w: [B, H, T, D]; u: [H, D]; s0 (optional) [B, H, D, D];
    s_out (optional) [B, H, D, D] float32, the final state's destination
    (may be ``s0``); commit (optional, with s_out) [B] bool.

    Returns (o [B, H, T, D] f32, s_final [B, H, D, D] f32); s_final is
    s_out when one is given, its uncommitted rows unchanged.
    """
    check_commit(s_out, commit)
    b, h, t, d = r.shape
    if s0 is None:
        s = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    else:
        s = s0.float()
    o = torch.empty((b, h, t, d), dtype=torch.float32, device=r.device)
    for i in range(t):
        o[:, :, i], s = wkv6_decode_step(s, r[:, :, i], k[:, :, i],
                                         v[:, :, i], w[:, :, i], u)
    if s_out is not None:
        s = write_state(s_out, s, commit)
    return o, s

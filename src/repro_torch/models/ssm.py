"""Chunked selective-state-space machinery (Mamba2 / SSD style).

Port of ``repro/models/ssm.py``. Recurrence per head h with state
S ∈ R^{P×N}:

    S_t = a_t · S_{t-1} + dt_t · x_t ⊗ B_t          (a_t = exp(-dt_t·exp(A_log)))
    y_t = S_t · C_t                                 (D_skip added by the caller)

``ssd_chunked`` is the reference's chunked formulation (the chunk length
L, halved until it divides T, and the cumulative log-decays): within a
chunk every pairwise decay is written through cumulative log-decays,
whose differences are <= 0 where they are used:

    cum_t = Σ_{j<=t} log a_j
    intra: y[t] += Σ_{i<=t} e^{cum_t - cum_i} (C_t·B_i) dt_i x_i
    state: y[t] += e^{cum_t} C_t · S0 ;  S' = e^{cum_L} S0 + Σ_i e^{cum_L-cum_i} dt_i x_i ⊗ B_i

The reference computes it outside any ``pallas_call``, so it is plain
PyTorch here too, in float32, with products of two operands (a
multi-operand ``einsum`` costs the host a contraction-path search per
call). Two changes from the reference, which leave every value alone:
the loop takes blocks of chunks where the reference scans chunk by chunk
(see ``ssd_chunked``), and the pairs i > t are masked *before* the
exponential (``exp(-inf) = 0``), where the reference exponentiates them
and masks the product — at hymba's chunk of 256 those positive
differences overflow to inf, which a backward pass turns into NaN.

State is written **in place**, as everywhere in the port's serving state:
with ``s_out`` (may be ``h0``/``S`` itself) the final state lands there,
and under ``commit`` ([B] bool) only in the committed rows — the serving
engine's masked decode wave.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.wkv6.ref import check_commit, write_state


#: tokens of the chunks one pass of ``ssd_chunked``'s loop takes at once
BLOCK_TOKENS = 1024


def _decay(dt: torch.Tensor, a_log: torch.Tensor) -> torch.Tensor:
    """log a = -dt · exp(A_log), float32; dt [..., H], a_log [H]."""
    return -dt.float() * torch.exp(a_log.float())


def _outer(dt, x, bmat) -> torch.Tensor:
    """dt · x ⊗ B: dt [..., H], x [..., H, P], B [..., H, N] ->
    [..., H, P, N]."""
    return (dt[..., None] * x)[..., None] * bmat[..., None, :]


def ssd_chunked(x, dt, a_log, bmat, cmat, *, h0=None, chunk: int = 256,
                s_out=None, commit=None):
    """x [B, T, H, P]; dt [B, T, H] (>0, post-softplus); a_log [H];
    bmat, cmat [B, T, H, N]; h0 [B, H, P, N] or None. Returns
    (y [B, T, H, P] f32, S [B, H, P, N] f32); S is ``s_out`` when one is
    given, its uncommitted rows unchanged.

    The reference scans the chunks one by one. Here a pass of the loop
    takes a block of chunks (BLOCK_TOKENS tokens) at once: each chunk's
    intra-chunk terms and its own contribution U_c to the state as one
    batched product, and the state entering each chunk of the block,
    S_c = e^{Σ_{c'<c} tot} S + Σ_{j<c} e^{Σ_{j<c'<c} tot} U_j, through
    the matrix of chunk decays — the same sums in another order. Where
    the chunk rule gives short chunks (T odd: L = 1) this keeps the loop
    at T / BLOCK_TOKENS passes instead of T."""
    check_commit(s_out, commit)
    b, t, h, p = x.shape
    n = bmat.shape[-1]
    L = min(chunk, t)
    while t % L:
        L //= 2
    nc = t // L
    per_block = max(1, BLOCK_TOKENS // L)
    dev = x.device

    def chunks(z):                          # [B, T, ...] -> [B, nc, L, ...]
        return z.float().reshape(b, nc, L, *z.shape[2:])

    xf, dtf, bf, cf = (chunks(z) for z in (x, dt, bmat, cmat))
    cum = torch.cumsum(_decay(dtf, a_log), dim=2)        # [B, nc, L, H]
    tot = cum[:, :, -1]                                  # [B, nc, H]
    ar = torch.arange(L, device=dev)
    tri = (ar[:, None] >= ar[None, :])[:, :, None]       # i <= t
    S = (torch.zeros((b, h, p, n), dtype=torch.float32, device=dev)
         if h0 is None else h0.float())

    ys = []
    for c0 in range(0, nc, per_block):
        blk = slice(c0, c0 + per_block)
        xc, dtc, bc, cc = xf[:, blk], dtf[:, blk], bf[:, blk], cf[:, blk]
        cu, tt = cum[:, blk], tot[:, blk]
        k = tt.shape[1]
        # intra-chunk: y[t] = Σ_{i<=t} e^{cum_t-cum_i} (C_t·B_i) dt_i x_i
        g = torch.einsum("bcthn,bcihn->bctih", cc, bc)   # [B, k, L, L, H]
        diff = cu[:, :, :, None] - cu[:, :, None]
        w = torch.exp(torch.where(tri, diff, -torch.inf)) * g \
            * dtc[:, :, None]
        y = torch.einsum("bctih,bcihp->bcthp", w, xc)
        # each chunk's own contribution to the state at its end
        u = torch.einsum("bclhp,bclhn->bchpn",
                         (torch.exp(tt[:, :, None] - cu) * dtc)[..., None]
                         * xc, bc)                       # [B, k, H, P, N]
        # the state entering each chunk of the block. The sums of chunk
        # totals run over up to BLOCK_TOKENS steps (hundreds in size): in
        # float64, so that their differences keep float32's precision
        # (the reference multiplies one chunk's decay at a time)
        T = torch.cumsum(tt.double(), dim=1)             # [B, k, H]
        tex = T - tt.double()
        ak = torch.arange(k, device=dev)
        before = (ak[:, None] > ak[None, :])[:, :, None]  # j < c
        dec = torch.exp(torch.where(before, tex[:, :, None] - T[:, None],
                                    -torch.inf)).float()  # [B, k, k, H]
        s_in = (torch.einsum("bcjh,bjhpn->bchpn", dec, u)
                + torch.exp(tex).float()[..., None, None] * S[:, None])
        # state term: y[t] += e^{cum_t} C_t · S_c
        y = y + torch.einsum("bcthn,bchpn->bcthp",
                             cc * torch.exp(cu)[..., None], s_in)
        S = (torch.exp(T[:, -1]).float()[..., None, None] * S
             + torch.einsum("bjh,bjhpn->bhpn",
                            torch.exp(T[:, -1:] - T).float(), u))
        ys.append(y)
    y = (ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)).reshape(b, t, h, p)
    if s_out is not None:
        S = write_state(s_out, S, commit)
    return y, S


def ssd_ref(x, dt, a_log, bmat, cmat, *, h0=None):
    """The naive per-step recurrence (the reference's oracle). Shapes as
    ``ssd_chunked``; returns (y [B, T, H, P] f32, S [B, H, P, N] f32)."""
    b, t, h, p = x.shape
    n = bmat.shape[-1]
    S = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    a = torch.exp(_decay(dt, a_log))                          # [B, T, H]
    upd = _outer(dt.float(), x.float(), bmat.float())        # [B,T,H,P,N]
    cf = cmat.float()
    ys = []
    for i in range(t):
        S = a[:, i, :, None, None] * S + upd[:, i]
        ys.append(torch.einsum("bhpn,bhn->bhp", S, cf[:, i]))
    return torch.stack(ys, dim=1), S


def ssd_decode_step(S, x, dt, a_log, bmat, cmat, *, s_out=None,
                    commit=None):
    """One-token step. x [B, H, P]; dt [B, H]; bmat/cmat [B, H, N];
    S [B, H, P, N]. Returns (y [B, H, P] f32, S' f32); S' is ``s_out``
    when one is given (may be ``S``), its uncommitted rows unchanged."""
    check_commit(s_out, commit)
    a = torch.exp(_decay(dt, a_log))                          # [B, H]
    new = (a[:, :, None, None] * S.float()
           + _outer(dt.float(), x.float(), bmat.float()))
    y = torch.einsum("bhpn,bhn->bhp", new, cmat.float())
    if s_out is not None:
        new = write_state(s_out, new, commit)
    return y, new

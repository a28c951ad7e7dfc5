"""RWKV6 "Finch" block (attention-free, data-dependent decay).

Port of ``repro/models/rwkv6.py``. Per layer:
  time-mix: token-shift lerps -> r, k, v, g projections; decay
            w_t = exp(-exp(w0 + tanh(x_w @ A) @ B)) (the low-rank
            data-dependent decay that defines Finch); WKV recurrence;
            per-head groupnorm; silu(g) gate; output projection.
  channel-mix: token-shift lerp; k = relu(x @ Wk)^2; out = (k @ Wv).

The WKV recurrence runs through one of (``impl``, the config's
``attn_impl``):
  "ref"     — kernels/wkv6/ref.py, a per-step loop (the reference's "ref")
  "chunked" — ``wkv6_chunked`` below, the reference's chunked math
              (plain PyTorch, a loop over chunks, stable exponents)
  "pallas"  — kernels/wkv6 (``wkv6``): the hand-written CUDA kernel for
              tensors on the card, its plain version on the CPU. The name
              is the reference's; unlike the reference, whose model never
              reaches its TPU kernel (it starts from a zero state), the
              port runs it on every time-mix, with the carried state.
              The kernel has no backward, so training through "pallas"
              raises (``kernels.refuse_grad``) where the reference's
              model trains through the chunked math: train with
              "chunked" or "ref".

State (``{"last": [B, 1, D], "s": [B, H, D, D] f32}`` for the time-mix,
``{"last"}`` for the channel-mix) is O(H·D²) per layer. Unlike the
reference, which returns new state arrays, the port writes the state's
tensors **in place**, and under ``commit`` ([B] bool) only the committed
rows: the serving engine's masked decode wave. The WKV route writes ``s``
itself (``s_out=s0``, with the mask); on "pallas" the kernel stores the
committed rows' final state and leaves the others untouched, so the
state makes no extra pass through device memory.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.distributed.spmd import align, is_dtensor, run_local
from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.kernels.wkv6.ref import check_commit, write_state, wkv6_ref
from repro_torch.models.layers import Dense, _param, dense, dtype_of, \
    init_dense

DECAY_LORA = 64
#: the per-head groupnorm's epsilon (the reference's, rwkv6.py:161)
GROUPNORM_EPS = 64e-5


class TimeMix(nn.Module):
    """``tm``: the lerps ``mu_*``, projections ``wr``/``wk``/``wv``/
    ``wg``/``wo``, the decay's base ``w0`` and low-rank ``w_lora_a``/
    ``w_lora_b``, the bonus ``u`` [H, hd] and the groupnorm's
    ``ln_scale``."""

    def __init__(self, mu, dense_, w0, u, ln_scale):
        super().__init__()
        for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
            setattr(self, name, _param(mu[name]))
        for name in ("wr", "wk", "wv", "wg", "wo", "w_lora_a", "w_lora_b"):
            setattr(self, name, dense_[name])
        self.w0 = _param(w0)
        self.u = _param(u)
        self.ln_scale = _param(ln_scale)


class ChannelMix(nn.Module):
    """``cm``: the lerp ``mu`` and the projections ``wk``, ``wv``."""

    def __init__(self, mu, wk: Dense, wv: Dense):
        super().__init__()
        self.mu = _param(mu)
        self.wk, self.wv = wk, wv


class RWKVBlock(nn.Module):
    def __init__(self, tm: TimeMix, cm: ChannelMix):
        super().__init__()
        self.tm, self.cm = tm, cm


def init_rwkv_block(init, cfg) -> RWKVBlock:
    d = cfg.d_model
    dt = dtype_of(cfg.param_dtype)
    hd = cfg.hd
    h = d // hd
    lora = min(DECAY_LORA, d)
    mu = {n: init.uniform((d,), dt)
          for n in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g")}
    dense_ = {n: init_dense(init, d, d, dt) for n in ("wr", "wk", "wv", "wg")}
    dense_["wo"] = init_dense(init, d, d, dt,
                              scale=d ** -0.5 / (2 * cfg.n_layers) ** 0.5)
    dense_["w_lora_a"] = init_dense(init, d, lora, dt)
    dense_["w_lora_b"] = init_dense(init, lora, d, dt,
                                    scale=lora ** -0.5 * 0.1)
    tm = TimeMix(mu, dense_, init.full((d,), -1.0, dt),   # base decay logit
                 init.normal((h, hd), 0.3, dt), init.full((d,), 1.0, dt))
    cm = ChannelMix(init.uniform((d,), dt), init_dense(init, d, cfg.d_ff, dt),
                    init_dense(init, cfg.d_ff, d, dt,
                               scale=cfg.d_ff ** -0.5))
    return RWKVBlock(tm, cm)


def _token_shift(x, last=None):
    """Shift right by one along T; ``last`` [B, 1, D] fills position 0."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _write(dst: torch.Tensor, new: torch.Tensor,
           commit: torch.Tensor | None) -> None:
    """``dst`` <- ``new`` in place; with ``commit`` ([B] bool) only the
    committed rows (dim 0), the others keep their values."""
    if commit is not None:
        new = torch.where(commit.view((-1,) + (1,) * (dst.dim() - 1)), new,
                          dst)
    dst.copy_(new)


def wkv6_chunked(r, k, v, w, u, *, s0=None, s_out=None, commit=None,
                 chunk: int = 64):
    """The reference's ``wkv6_chunked_jnp``: the TPU kernel's chunked math,
    vectorised over [B, H], a Python loop where the reference scans.

    r/k/v/w [B, H, T, D]; u [H, D] -> (o [B,H,T,D] f32, s [B,H,D,D] f32).
    ``s_out`` and ``commit`` as for ``kernels/wkv6/ops.py::wkv6``: the
    final state written in place, only into the committed rows.
    """
    check_commit(s_out, commit)
    b, h, t, d = r.shape
    L = min(chunk, t)
    while t % L:
        L //= 2
    rf, kf, vf, wf = (z.float() for z in (r, k, v, w))
    uf = u.float()
    S = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    tri = (torch.arange(L, device=r.device)[:, None]
           > torch.arange(L, device=r.device)[None, :])
    outs = []
    for c0 in range(0, t, L):
        rc, kc, vc, wc = (z[:, :, c0:c0 + L] for z in (rf, kf, vf, wf))
        lw = torch.log(wc)
        s_incl = torch.cumsum(lw, dim=2)
        s_excl = s_incl - lw
        q = rc * torch.exp(s_excl)
        o = torch.einsum("bhld,bhde->bhle", q, S)
        # intra: A[t,i] = Σ_d r[t,d] k[i,d] e^{s_excl[t,d]-s_incl[i,d]}
        expd = torch.exp(s_excl[:, :, :, None, :] - s_incl[:, :, None, :, :])
        a = (rc[:, :, :, None, :] * kc[:, :, None, :, :] * expd).sum(-1)
        a = torch.where(tri, a, 0.0)
        diag = (rc * kc * uf[None, :, None, :]).sum(-1)
        o = o + torch.einsum("bhti,bhid->bhtd", a, vc) + diag[..., None] * vc
        tot = s_incl[:, :, -1]                      # [B, H, D]
        k_dec = kc * torch.exp(tot[:, :, None, :] - s_incl)
        S = (torch.exp(tot)[:, :, :, None] * S
             + torch.einsum("bhlk,bhlv->bhkv", k_dec, vc))
        outs.append(o)
    if s_out is not None:
        S = write_state(s_out, S, commit)
    return torch.cat(outs, dim=2), S


def rwkv_time_mix(p: TimeMix, x, cfg, *, state=None, impl="chunked",
                  commit=None):
    """x [B, T, D] (the normed input). ``state``: ``{"last" [B, 1, D],
    "s" [B, H, D, D]}`` or None; updated in place (``commit`` rows only).
    Returns out [B, T, D]."""
    hd = cfg.hd
    last = None if state is None else state["last"]
    xs = _token_shift(x, last)

    def mix(mu):
        return x + (xs - x) * mu

    r = dense(p.wr, mix(p.mu_r))
    k = dense(p.wk, mix(p.mu_k))
    v = dense(p.wv, mix(p.mu_v))
    g = F.silu(dense(p.wg, mix(p.mu_g)))
    xw = mix(p.mu_w)
    wlog = p.w0.float() + dense(p.w_lora_b,
                                torch.tanh(dense(p.w_lora_a, xw))).float()
    w = torch.exp(-torch.exp(wlog))                 # (0,1) data-dependent

    # the heads (each rank's on a mesh): w is cast to x's dtype before the
    # WKV, as in the reference (:142)
    wx = w.to(x.dtype)
    if is_dtensor(r) and wx.placements != r.placements:
        wx = wx.redistribute(placements=r.placements)   # a local slice
    kw = {} if state is None else dict(s0=state["s"], s_out=state["s"],
                                       commit=commit)
    o = run_local(_wkv_heads, r, (r, k, v, wx, align(p.u, r, 2, 0), kw),
                  out_placements=None, hd=hd, impl=impl)
    o = o * p.ln_scale.float()
    o = o.to(x.dtype) * g

    out = dense(p.wo, o)
    if state is not None:
        _write(state["last"], x[:, -1:], commit)
    return out


def _wkv_heads(r, k, v, w, u, state_kw, *, hd, impl):
    """The per-head part of the time-mix: r/k/v/w [B, T, H·hd] -> the WKV
    through ``impl`` (the state in ``state_kw`` read and written in place)
    and the per-head groupnorm -> [B, T, H·hd] float32."""
    b, t, d = r.shape
    h = d // hd

    def split(z):
        return z.reshape(b, t, h, hd).transpose(1, 2)

    wkv = {"pallas": wkv6, "ref": wkv6_ref}.get(impl, wkv6_chunked)
    o, _ = wkv(split(r), split(k), split(v), split(w), u.float(), **state_kw)
    # per-head groupnorm (population variance, as jnp.var)
    mean = o.mean(dim=-1, keepdim=True)
    var = o.var(dim=-1, keepdim=True, correction=0)
    o = (o - mean) * torch.rsqrt(var + GROUPNORM_EPS)
    return o.transpose(1, 2).reshape(b, t, d)


def rwkv_channel_mix(p: ChannelMix, x, *, state=None, commit=None):
    """x [B, T, D] (the normed input); ``state``: ``{"last"}`` or None,
    updated in place. Returns out [B, T, D]."""
    last = None if state is None else state["last"]
    xs = _token_shift(x, last)
    xm = x + (xs - x) * p.mu
    k = torch.square(F.relu(dense(p.wk, xm)))
    out = dense(p.wv, k)
    if state is not None:
        _write(state["last"], x[:, -1:], commit)
    return out

"""Hymba hybrid block — *parallel* attention + Mamba (SSD) heads per layer.

Port of ``repro/models/hymba.py`` (arXiv:2411.13676): within each layer
the input feeds an attention branch and an SSM branch at once; each
branch's output is normalized and the two are averaged. Most layers use
sliding-window attention; ``global_layers`` (first / middle / last) use
full attention. The 128 learned meta tokens are prepended by the model
(``api.py``).

For decode the layer carries a (windowed) KV ring and the O(1) SSM state
``[B, H, P, N]`` float32; both are written in place, under ``commit``
only the committed rows (the serving engine's masked decode wave).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.models.attention import Attention, attention, init_attention
from repro_torch.models.layers import (
    RMSNorm,
    _param,
    dense,
    dtype_of,
    init_dense,
    init_rmsnorm,
    rmsnorm,
)
from repro_torch.distributed.spmd import align, run_local, settle
from repro_torch.models.ssm import ssd_chunked, ssd_decode_step


class SSMBranch(nn.Module):
    """``ssm``: projections ``w_x``, ``w_z``, ``w_b``, ``w_c``, ``w_dt``,
    ``w_out``; per-head ``dt_bias``, ``a_log``, ``d_skip`` (float32)."""

    def __init__(self, dense_: dict, dt_bias, a_log, d_skip):
        super().__init__()
        for name in ("w_x", "w_z", "w_b", "w_c", "w_dt", "w_out"):
            setattr(self, name, dense_[name])
        self.dt_bias = _param(dt_bias)
        self.a_log = _param(a_log)
        self.d_skip = _param(d_skip)


class HymbaBlock(nn.Module):
    def __init__(self, attn: Attention, ssm: SSMBranch, norm_attn: RMSNorm,
                 norm_ssm: RMSNorm):
        super().__init__()
        self.attn, self.ssm = attn, ssm
        self.norm_attn, self.norm_ssm = norm_attn, norm_ssm


def ssm_heads(cfg) -> int:
    return cfg.ssm.n_heads or cfg.d_model // cfg.ssm.head_dim


def init_hymba_block(init, cfg) -> HymbaBlock:
    d = cfg.d_model
    s = cfg.ssm
    nh, p_dim, n = ssm_heads(cfg), s.head_dim, s.state_dim
    dt = dtype_of(cfg.param_dtype)
    f32 = torch.float32
    dense_ = {"w_x": init_dense(init, d, nh * p_dim, dt),
              "w_z": init_dense(init, d, nh * p_dim, dt),
              "w_b": init_dense(init, d, nh * n, dt),
              "w_c": init_dense(init, d, nh * n, dt),
              "w_dt": init_dense(init, d, nh, dt),
              "w_out": init_dense(init, nh * p_dim, d, dt,
                                  scale=(nh * p_dim) ** -0.5
                                  / (2 * cfg.n_layers) ** 0.5)}
    ssm = SSMBranch(dense_, init.full((nh,), 0.0, f32),
                    init.full((nh,), 0.0, f32), init.full((nh,), 1.0, f32))
    return HymbaBlock(init_attention(init, cfg), ssm,
                      init_rmsnorm(init, d, dt), init_rmsnorm(init, d, dt))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``, op for op
    (``F.softplus`` switches to x above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssm_branch(p: SSMBranch, x, cfg, *, state=None, decode=False,
               commit=None):
    """x [B, T, D] -> out [B, T, D]. ``state`` ([B, H, P, N] float32, or
    None) is the carried SSM state, updated in place (``commit`` rows)."""
    b, t, d = x.shape
    s = cfg.ssm
    nh, pd, n = ssm_heads(cfg), s.head_dim, s.state_dim

    xh = dense(p.w_x, x).reshape(b, t, nh, pd)
    z = F.silu(dense(p.w_z, x)).reshape(b, t, nh, pd)
    bm = dense(p.w_b, x).reshape(b, t, nh, n)
    cm = dense(p.w_c, x).reshape(b, t, nh, n)
    dt_ = softplus(dense(p.w_dt, x).float() + p.dt_bias[None, None])  # [B,T,H]

    y = run_local(_ssd_heads, xh, (xh, z, bm, cm, dt_,
                                   align(p.a_log, xh, 2, 0),
                                   align(p.d_skip, xh, 2, 0), state, commit),
                  out_placements=None, decode=decode, chunk=s.chunk,
                  dtype=x.dtype)
    return dense(p.w_out, y)


def _ssd_heads(xh, z, bm, cm, dt_, a_log, d_skip, state, commit, *, decode,
               chunk, dtype):
    """The per-head part of ``ssm_branch`` (each rank's heads on a mesh):
    the SSD scan (or one decode step), the skip and the gate -> y
    [B, T, H·P]."""
    b, t, nh, pd = xh.shape
    kw = {} if state is None else dict(s_out=state, commit=commit)
    if decode:
        if t != 1:
            raise ValueError(f"a decode step takes one token, got T={t}")
        y, _ = ssd_decode_step(state, xh[:, 0], dt_[:, 0], a_log,
                               bm[:, 0], cm[:, 0], **kw)
        y = y[:, None]                                   # [B, 1, H, P]
    else:
        y, _ = ssd_chunked(xh, dt_, a_log, bm, cm, h0=state, chunk=chunk,
                           **kw)
    y = y + d_skip[None, None, :, None] * xh.float()
    return (y.to(dtype) * z).reshape(b, t, nh * pd)


def hymba_block(p: HymbaBlock, x, cfg, *, positions, is_global: bool,
                cache=None, ssm_state=None, mode: str = "train",
                commit=None):
    """Parallel attention + SSM; ``is_global`` picks full attention or
    the sliding window. The KV ring and the SSM state (if given) are
    updated in place. Returns out [B, T, D]."""
    window = None if is_global else cfg.sliding_window
    attn_out = attention(p.attn, x, cfg, positions=positions, causal=True,
                         window=window, cache=cache, mode=mode,
                         commit=commit)
    ssm_out = ssm_branch(p.ssm, x, cfg, state=ssm_state,
                         decode=mode == "decode", commit=commit)
    return 0.5 * (rmsnorm(p.norm_attn, settle(attn_out, x), cfg.norm_eps)
                  + rmsnorm(p.norm_ssm, settle(ssm_out, x), cfg.norm_eps))

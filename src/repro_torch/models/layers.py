"""Primitive layers: parameter containers and plain functions on tensors.

Port of ``repro/models/layers.py``. The reference keeps parameters in a
pytree of dicts; here each dict is an ``nn.Module`` whose parameters carry
the reference's leaf names (``w``, ``b``, ``scale``, ``table``), so a
module tree's ``named_parameters()`` reads as the reference's pytree paths
(``segments.0.3.attn.wq.w``). The apply functions take those modules the
way the reference's take dicts. ``Dense`` keeps its weight as
``[d_in, d_out]`` and computes ``x @ w``, as the reference does, so the
bridge copies weights across without transposes.

Parameters are created with ``requires_grad=False``, so serving and
evaluation build no autograd graph; the training path
(``train/step.py::init_train_state``) turns gradients on for its own
parameters.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.distributed.spmd import (
    is_dtensor,
    mesh_coordinate,
    run_local,
    split_along,
)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float8_e4m3fn": torch.float8_e4m3fn}


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# ----------------------------------------------------------- containers
class Dense(nn.Module):
    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = _param(w)
        self.b = None if b is None else _param(b)


class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = _param(scale)


class Embedding(nn.Module):
    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.table = _param(table)


class SwiGLU(nn.Module):
    def __init__(self, w_gate: Dense, w_up: Dense, w_out: Dense):
        super().__init__()
        self.w_gate, self.w_up, self.w_out = w_gate, w_up, w_out


# ----------------------------------------------------------------- init
class Init:
    """Where and how new parameters are made: ``normal`` draws from
    ``generator`` (on ``device``); with ``generator=None`` every tensor
    is left uninitialized (``torch.empty``), for the bridge to fill."""

    def __init__(self, device: torch.device,
                 generator: torch.Generator | None):
        self.device = device
        self.generator = generator

    def normal(self, shape, std: float, dtype) -> torch.Tensor:
        if self.generator is None:
            return torch.empty(shape, dtype=dtype, device=self.device)
        x = torch.randn(shape, generator=self.generator,
                        dtype=torch.float32, device=self.device)
        return (x * std).to(dtype)

    def uniform(self, shape, dtype) -> torch.Tensor:
        """U[0, 1) in float32, then ``dtype`` (the RWKV lerps)."""
        if self.generator is None:
            return torch.empty(shape, dtype=dtype, device=self.device)
        x = torch.rand(shape, generator=self.generator, dtype=torch.float32,
                       device=self.device)
        return x.to(dtype)

    def full(self, shape, value: float, dtype) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=self.device)


def init_dense(init: Init, d_in, d_out, dtype, *, scale=None,
               bias=False) -> Dense:
    scale = scale if scale is not None else d_in ** -0.5
    w = init.normal((d_in, d_out), scale, dtype)
    return Dense(w, init.full((d_out,), 0.0, dtype) if bias else None)


def init_rmsnorm(init: Init, d, dtype) -> RMSNorm:
    return RMSNorm(init.full((d,), 1.0, dtype))


def init_embedding(init: Init, vocab, d, dtype) -> Embedding:
    return Embedding(init.normal((vocab, d), 0.02, dtype))


def init_swiglu(init: Init, d, f, dtype) -> SwiGLU:
    return SwiGLU(init_dense(init, d, f, dtype),
                  init_dense(init, d, f, dtype),
                  init_dense(init, f, d, dtype, scale=f ** -0.5))


# -------------------------------------------------------------- apply
def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w
    if p.b is not None:
        y = y + p.b
    return y


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.scale.float()).to(x.dtype)


def embed(p: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    if is_dtensor(p.table):
        return _embed_sharded(p.table, tokens)
    return p.table[tokens]


def _embed_sharded(table, tokens):
    """The lookup on a mesh: each rank looks up the rows of the table it
    holds (a vocab-parallel table, rows split over "model") and zeros the
    others; the partial sums are reduced once, to the tokens' placements.
    (DTensor's own embedding rule leaves a masked partial that cannot be
    reduced twice, and the residual stream and the backward both read
    it.)"""
    from torch.distributed.tensor import Partial

    rows = split_along(table, "model") == 0
    m, msz = mesh_coordinate(table, "model")
    n = table.shape[0] // msz if rows else table.shape[0]

    def lookup(t, tok):
        if not rows:
            return t[tok]
        idx = tok.long() - m * n
        ok = (idx >= 0) & (idx < n)
        return torch.where(ok[..., None], t[idx.clamp(0, n - 1)], 0.0)

    out = list(tokens.placements)
    if rows:
        out[table.device_mesh.mesh_dim_names.index("model")] = Partial()
    y = run_local(lookup, tokens, (table, tokens), out_placements=out)
    return y.redistribute(placements=tokens.placements)


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(dense(p.w_gate, x))
    u = dense(p.w_up, x)
    return dense(p.w_out, g * u)


# ----------------------------------------------------------------- rope
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x [..., T, H, hd]; positions [..., T] (broadcastable)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = theta ** exps   # a Python base: no host-to-device copy
    ang = positions[..., :, None].float() * freqs       # [..., T, half]
    cos = torch.cos(ang)[..., None, :]                  # over heads
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  z_loss: float = 0.0) -> torch.Tensor:
    """logits [..., V] (any float dtype), labels int [...]. Mean loss in
    float32; label -100 (any negative) masks the position out."""
    if is_dtensor(logits):
        # the vocab whole on every rank (an all-gather of a vocab-sharded
        # head), the rows as the labels' (batch over the data axes)
        logits = logits.redistribute(placements=labels.placements)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse ** 2
    mask = (labels >= 0).float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)

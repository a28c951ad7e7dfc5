"""Mixture-of-Experts layer — sort-based capacity dispatch.

Port of ``repro/models/moe.py`` (its no-mesh path; the expert-parallel
``moe_sharded.py`` belongs to the sharded LM modules). Per layer:

  1. router top-k over E experts (router in float32)
  2. flatten the (token, choice) pairs, stable-sort them by expert id
  3. rank within expert from the sorted ids (position - expert's start)
  4. scatter into a dense [E, C, D] buffer of capacity
     C = int(N·k/E·capacity_factor + 1); a pair ranked past C goes to a
     trash row (slot C) and is dropped — the overflow fraction is
     reported, the wavefront analogy of the tasks that cannot enter the
     current wave
  5. batched expert GEMMs ``einsum('ecd,edf->ecf')``
  6. gather back and the gate-weighted combine

The dispatch matches the reference's op for op, because which pairs are
dropped depends on it: a stable argsort (``jnp.argsort`` is stable),
``repeat_interleave`` for ``jnp.repeat``, per-expert counts, the
trash row at slot C and the same Python capacity. Every row of ``x``
competes for capacity: a decode step's idle slots too, as in the
reference's engine.

Arctic mode (``dense_parallel``): a dense SwiGLU runs beside the experts
and the outputs add.

The reference computes all of this outside any ``pallas_call``; it is
plain PyTorch here too.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.distributed.spmd import is_dtensor, run_local
from repro_torch.models.layers import (
    Dense,
    SwiGLU,
    _param,
    dense,
    dtype_of,
    init_dense,
    init_swiglu,
    swiglu,
)


class Experts(nn.Module):
    """``experts``: stacked ``w_gate``, ``w_up`` [E, D, F] and ``w_out``
    [E, F, D]."""

    def __init__(self, w_gate, w_up, w_out):
        super().__init__()
        self.w_gate = _param(w_gate)
        self.w_up = _param(w_up)
        self.w_out = _param(w_out)


class MoE(nn.Module):
    """``router`` (float32 ``Dense``), ``experts`` and, for Arctic,
    ``dense_mlp``."""

    def __init__(self, router: Dense, experts: Experts,
                 dense_mlp: SwiGLU | None = None):
        super().__init__()
        self.router, self.experts = router, experts
        self.dense_mlp = dense_mlp


def init_moe(init, cfg) -> MoE:
    m = cfg.moe
    d = cfg.d_model
    dt = dtype_of(cfg.param_dtype)
    e, fe = m.n_experts, m.d_expert
    experts = Experts(init.normal((e, d, fe), d ** -0.5, dt),
                      init.normal((e, d, fe), d ** -0.5, dt),
                      init.normal((e, fe, d), fe ** -0.5, dt))
    return MoE(init_dense(init, d, e, torch.float32), experts,
               init_swiglu(init, d, cfg.d_ff, dt) if m.dense_parallel
               else None)


def capacity(n_tokens: int, cfg) -> int:
    """Slots per expert: the reference's ``int(n·k/E·cf + 1)``."""
    m = cfg.moe
    return int(n_tokens * m.top_k / m.n_experts * m.capacity_factor + 1)


def expert_counts(se: torch.Tensor, e: int) -> torch.Tensor:
    """The pairs routed to each of the ``e`` experts (int64 [E]): the
    reference's ``bincount(length=E)``, as a scatter-add, which has a
    meta-device kernel (the dry run traces the layer there)."""
    return torch.zeros(e, dtype=torch.int64, device=se.device).scatter_add_(
        0, se, torch.ones_like(se))


def moe_layer(p: MoE, x: torch.Tensor, cfg):
    """x [B, S, D] -> (y [B, S, D], aux: ``load_balance_loss``,
    ``router_z_loss``, ``overflow_fraction`` as float32 scalars)."""
    if is_dtensor(x):
        return _moe_replicated(p, x, cfg)
    m = cfg.moe
    b, s, d = x.shape
    n = b * s
    e, k = m.n_experts, m.top_k
    cap = capacity(n, cfg)
    dev = x.device

    xf = x.reshape(n, d)
    logits = dense(p.router, xf.float())                       # [N, E]
    probs = torch.softmax(logits, dim=-1)
    gates, choice = torch.topk(probs, k, dim=-1)               # [N, k]
    gates = gates / gates.sum(dim=-1, keepdim=True)

    # ---- flatten (token, choice) pairs and sort by expert ----
    flat_e = choice.reshape(-1)                                # [N·k]
    flat_t = torch.arange(n, device=dev).repeat_interleave(k)
    flat_g = gates.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]

    # rank within expert: position - first position of the expert
    counts = expert_counts(se, e)                   # [E]
    starts = torch.cumsum(counts, dim=0) - counts
    rank = torch.arange(n * k, device=dev) - starts[se]
    keep = rank < cap
    slot = torch.where(keep, rank, cap)                        # cap = trash

    # ---- dispatch: [E, C+1, D] buffer (+1 trash row) ----
    buf = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=dev)
    buf = buf.index_put((se, slot), xf[st], accumulate=True)
    buf = buf[:, :cap]

    # ---- batched expert GEMMs ----
    w = p.experts
    g = F.silu(torch.einsum("ecd,edf->ecf", buf, w.w_gate))
    u = torch.einsum("ecd,edf->ecf", buf, w.w_up)
    y = torch.einsum("ecf,efd->ecd", g * u, w.w_out)           # [E, C, D]

    # ---- combine ----
    contrib = y[se, torch.where(keep, rank, 0)]                # [N·k, D]
    contrib = torch.where(keep[:, None], contrib, 0.0)
    out = torch.zeros((n, d), dtype=y.dtype, device=dev).index_add(
        0, st, contrib * sg[:, None].to(y.dtype))

    # ---- aux losses / metrics ----
    me = probs.mean(dim=0)                                     # [E]
    ce = F.one_hot(choice, e).sum(dim=1).float().mean(dim=0)   # tokens/exp
    load_balance = e * (me * ce).sum() / k
    z = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    overflow = 1.0 - keep.float().mean()

    out = out.reshape(b, s, d).to(x.dtype)
    if p.dense_mlp is not None:
        out = out + swiglu(p.dense_mlp, x)
    aux = {"load_balance_loss": load_balance, "router_z_loss": z,
           "overflow_fraction": overflow}
    return out, aux


class _Namespace(dict):
    """Dotted access to a dict of tensors (None for a missing name): a
    parameter tree of local tensors that ``moe_layer`` reads as it reads
    its module."""

    def __getattr__(self, name):
        return self.get(name)


def _as_tree(named: dict) -> _Namespace:
    root = _Namespace()
    for name, t in named.items():
        *path, leaf = name.split(".")
        node = root
        for part in path:
            node = node.setdefault(part, _Namespace())
        node[leaf] = t
    return root


def _moe_replicated(p: MoE, x, cfg):
    """The dense dispatch on a mesh: the capacity and the drops are the
    whole batch's (the reference's GSPMD keeps the single-device
    semantics), so the tokens and the layer's parameters are replicated
    here explicitly (all-gathers; the experts' shards over the data axes
    and "model" gathered per layer) and every rank runs the dispatch on
    the whole batch; ``moe_impl="shard_map"`` is the expert-parallel
    schedule (``moe_sharded.py``)."""
    from torch.distributed.tensor import Replicate

    rep = [Replicate()] * x.device_mesh.ndim
    named = {n: t.redistribute(placements=rep)
             for n, t in p.named_parameters()}
    xr = x.redistribute(placements=rep)
    return run_local(lambda xl, lv: moe_layer(_as_tree(lv), xl, cfg), xr,
                     (xr, named), out_placements=[rep] * 4)

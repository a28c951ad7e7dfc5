"""Composable decoder/encoder stack of every family.

Port of ``repro/models/transformer.py``. The stack is a list of
*segments*, runs of consecutive layers with one block structure, as in
the reference; where the reference scans a segment's stacked parameters
with ``lax.scan``, the port holds one module per layer
(``segments.<i>.<layer>``) and loops over them in Python. Layer kinds:

  attn   — GQA attention (optional sliding window / QKV bias) + SwiGLU
  moe    — GQA attention + MoE FFN (optional Arctic dense-parallel
           branch, models/moe.py)
  rwkv   — RWKV6 time-mix + channel-mix (models/rwkv6.py)
  hymba  — parallel attention + SSM heads + SwiGLU (models/hymba.py);
           hymba's global layers form their own segments
  enc    — bidirectional attention + SwiGLU (the encoder)
  xdec   — causal self-attention + cross-attention to the encoder's
           output + SwiGLU

As in the reference, ``plan_segments`` gives the encoder-decoder's
decoder ``attn`` segments: ``xdec`` is a kind no plan picks, so the
encoder's output reaches no logit of seamless-m4t in either package
(PERF.md, open questions). The layer kind is ported and held against the
reference's layer on its own.

Under a mesh (``distributed/context.py``) the parameters, the batch and
the states are DTensors (``distributed/sharding.py``) and the same code
runs on them; the mesh knobs act as in the reference: ``moe_impl``
``"shard_map"``/``"shard_map_wg"`` runs the expert-parallel MoE
(``moe_sharded.py``), ``tp_shard_map`` the Megatron-SP block
(``block_sharded.py``: training without a cache, when the q heads divide
the model axis), and ``seq_parallel`` places the residual stream
sequence-sharded over model between blocks (values unchanged). Without a
mesh they change nothing, as in the reference.

Streaming state keeps the reference's **stacked** layout: every leaf of a
segment's state has a leading layer axis (``k`` [L, B, Hkv, Smax, hd],
``length`` [L, B], ``tm.s`` [L, B, H, hd, hd], hymba's ``ssm``
[L, B, H, P, N], ...), so the serving engine resets or reads a slot with
one op per leaf. A layer works on views of its row of each leaf, and its
state writes land in the stacked tensors in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.context import get_mesh
from repro_torch.distributed.sharding import (
    P,
    data_axes,
    mesh_axes,
    spec_placements,
)
from repro_torch.distributed.spmd import is_dtensor, settle
from repro_torch.obs.costs import current_recorder, loop as cost_loop
from repro_torch.models.attention import (
    attention,
    init_attention,
    init_kv_cache,
    map_state,
)
from repro_torch.models.hymba import hymba_block, init_hymba_block, ssm_heads
from repro_torch.models.layers import (
    DTYPES,
    Dense,
    _param,
    dtype_of,
    init_embedding,
    init_rmsnorm,
    init_swiglu,
    rmsnorm,
    swiglu,
)
from repro_torch.models.moe import init_moe, moe_layer
from repro_torch.models.rwkv6 import (
    init_rwkv_block,
    rwkv_channel_mix,
    rwkv_time_mix,
)


@dataclass(frozen=True)
class Segment:
    kind: str
    n_layers: int
    is_global: bool = True    # full attention (False -> cfg.sliding_window)


# --------------------------------------------------------------- planning
def plan_segments(cfg) -> list[Segment]:
    """The reference's segment plan, for every family."""
    fam = cfg.family
    L = cfg.n_layers
    if fam == "ssm":
        return [Segment("rwkv", L)]
    if fam == "moe":
        return [Segment("moe", L, is_global=cfg.sliding_window is None)]
    if fam == "hybrid":
        segs: list[Segment] = []
        glob = set(cfg.global_layers)
        i = 0
        while i < L:
            g = i in glob
            j = i
            while j < L and (j in glob) == g:
                j += 1
            segs.append(Segment("hymba", j - i, is_global=g))
            i = j
        return segs
    # dense / vlm / audio-decoder
    return [Segment("attn", L, is_global=cfg.sliding_window is None)]


def plan_encoder_segments(cfg) -> list[Segment]:
    return [Segment("enc", cfg.enc_layers)] if cfg.is_encdec else []


# ------------------------------------------------------------------ params
class Layer(nn.Module):
    """One block, its parts named as the reference's per-layer pytree
    keys: ``attn``/``enc`` — norm1, attn, norm2, mlp; ``xdec`` — also
    normx, xattn; ``moe`` — norm1, attn, norm2, moe; ``hymba`` — norm1,
    hymba, norm2, mlp; ``rwkv`` — norm1, rwkv, norm2."""

    def __init__(self, **parts: nn.Module):
        super().__init__()
        for name, part in parts.items():
            setattr(self, name, part)


class LMParams(nn.Module):
    """The parameter tree: ``embed.table``, ``segments.<i>.<layer>...``,
    ``final_norm.scale``; without tied embeddings ``lm_head.w``; with
    meta tokens ``prefix`` [n, D]; for the encoder-decoder
    ``enc_segments.<i>.<layer>...`` and ``enc_final_norm.scale``."""

    def __init__(self, embed, segments, final_norm, lm_head=None,
                 prefix=None, enc_segments=None, enc_final_norm=None):
        super().__init__()
        self.embed = embed
        self.segments = nn.ModuleList(nn.ModuleList(s) for s in segments)
        self.final_norm = final_norm
        self.lm_head = lm_head
        self.prefix = None if prefix is None else _param(prefix)
        self.enc_segments = (None if enc_segments is None else nn.ModuleList(
            nn.ModuleList(s) for s in enc_segments))
        self.enc_final_norm = enc_final_norm


def init_layer(init, cfg, kind: str) -> Layer:
    dt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    if kind == "rwkv":
        return Layer(norm1=init_rmsnorm(init, d, dt),
                     rwkv=init_rwkv_block(init, cfg),
                     norm2=init_rmsnorm(init, d, dt))
    parts: dict[str, nn.Module] = {"norm1": init_rmsnorm(init, d, dt)}
    if kind == "hymba":
        parts["hymba"] = init_hymba_block(init, cfg)
    else:
        parts["attn"] = init_attention(init, cfg)
    if kind == "xdec":
        parts["normx"] = init_rmsnorm(init, d, dt)
        parts["xattn"] = init_attention(init, cfg, cross=True)
    parts["norm2"] = init_rmsnorm(init, d, dt)
    if kind == "moe":
        parts["moe"] = init_moe(init, cfg)
    else:
        parts["mlp"] = init_swiglu(init, d, cfg.d_ff, dt)
    return Layer(**parts)


def init_params(cfg, init) -> LMParams:
    dt = dtype_of(cfg.param_dtype)

    def stack(segs):
        return [[init_layer(init, cfg, s.kind) for _ in range(s.n_layers)]
                for s in segs]

    lm_head = prefix = enc = enc_norm = None
    if not cfg.tie_embeddings:
        lm_head = Dense(init.normal((cfg.d_model, cfg.vocab), 0.02, dt))
    if cfg.n_prefix_tokens:
        prefix = init.normal((cfg.n_prefix_tokens, cfg.d_model), 0.02, dt)
    if cfg.is_encdec:
        enc = stack(plan_encoder_segments(cfg))
        enc_norm = init_rmsnorm(init, cfg.d_model, dt)
    return LMParams(
        init_embedding(init, cfg.vocab, cfg.d_model, dt),
        stack(plan_segments(cfg)),
        init_rmsnorm(init, cfg.d_model, dt),
        lm_head, prefix, enc, enc_norm)


# ------------------------------------------------------------ layer apply
def _layer_state(state: dict | None, i: int):
    """Layer i's state: views of row i of the stacked leaves."""
    if state is None:
        return None
    return map_state(lambda x: x[i], state)


def apply_layer(kind: str, lp: Layer, x, cfg, *, positions, is_global,
                state, mode, commit=None, enc_out=None):
    """One block of ``kind``; ``state`` (the layer's views, or None) is
    updated in place, only the ``commit`` rows under a mask. Returns
    (x, aux): the MoE layer's aux dict, None for the other kinds."""
    if kind == "rwkv":
        st = state or {"tm": None, "cm": None}
        x = x + settle(rwkv_time_mix(
            lp.rwkv.tm, rmsnorm(lp.norm1, x, cfg.norm_eps), cfg,
            state=st["tm"], impl=cfg.attn_impl, commit=commit), x)
        return x + settle(rwkv_channel_mix(
            lp.rwkv.cm, rmsnorm(lp.norm2, x, cfg.norm_eps), state=st["cm"],
            commit=commit), x), None

    if kind == "hymba":
        st = state or {"kv": None, "ssm": None}
        x = x + settle(hymba_block(
            lp.hymba, rmsnorm(lp.norm1, x, cfg.norm_eps), cfg,
            positions=positions, is_global=is_global, cache=st["kv"],
            ssm_state=st["ssm"], mode=mode, commit=commit), x)
        return x + settle(swiglu(lp.mlp, rmsnorm(lp.norm2, x, cfg.norm_eps)),
                          x), None

    # attention families
    window = None if is_global else cfg.sliding_window
    if kind == "attn" and cfg.tp_shard_map and mode == "train" \
            and state is None:
        mesh = get_mesh()
        if mesh is not None and "model" in mesh_axes(mesh) \
                and cfg.n_heads % mesh_axes(mesh)["model"] == 0:
            from repro_torch.models.block_sharded import \
                attn_mlp_block_sharded

            return attn_mlp_block_sharded(lp, x, cfg, positions=positions,
                                          window=window, mesh=mesh), None
    x = x + settle(attention(
        lp.attn, rmsnorm(lp.norm1, x, cfg.norm_eps), cfg,
        positions=positions, causal=kind != "enc", window=window,
        cache=None if state is None else state["kv"], mode=mode,
        commit=commit), x)
    if kind == "xdec":
        # cross-attention: K/V from the encoder's output, no rope, no
        # mask, no cache (recomputed every step, as in the reference)
        x = x + settle(attention(
            lp.xattn, rmsnorm(lp.normx, x, cfg.norm_eps), cfg,
            positions=None, causal=False, kv_input=enc_out, mode="train"), x)
    hn = rmsnorm(lp.norm2, x, cfg.norm_eps)
    if kind == "moe":
        mesh = get_mesh() if cfg.moe_impl.startswith("shard_map") else None
        if mesh is not None:
            from repro_torch.models.moe_sharded import moe_layer_sharded

            h, aux = moe_layer_sharded(lp.moe, hn, cfg, mesh)
        else:
            h, aux = moe_layer(lp.moe, hn, cfg)
        return x + settle(h, x), aux
    return x + settle(swiglu(lp.mlp, hn), x), None


#: the MoE layer's aux values, summed over the layers (0 elsewhere)
AUX_KEYS = ("load_balance_loss", "router_z_loss", "overflow_fraction")


def _zero_aux(device) -> dict[str, torch.Tensor]:
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in AUX_KEYS}


def _sp_constraint(x, cfg):
    """Megatron-style sequence parallelism: between blocks the residual
    stream is sharded over (T -> model), a redistribute of the DTensor
    (values unchanged); nothing without a mesh."""
    if not cfg.seq_parallel or x.shape[1] % 16 or not is_dtensor(x):
        return x
    mesh = get_mesh()
    if mesh is None or "model" not in mesh_axes(mesh):
        return x
    dax = data_axes(mesh)
    bspec = (dax if len(dax) > 1 else dax[0]) if dax else None
    return x.redistribute(placements=spec_placements(
        P(bspec, "model", None), mesh))


def _whole_sequence(x):
    """The residual stream whole along T again after sequence-parallel
    blocks (``tp_shard_map``, ``seq_parallel``): the final norm and the
    head read whole rows, and DTensor (torch 2.11) cannot flatten a
    sequence-sharded [B, T, D] for the head's product. A redistribute
    (an all-gather over model); nothing without a mesh."""
    if not is_dtensor(x) or not any(p.is_shard(1) for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(placements=[
        Replicate() if p.is_shard(1) else p for p in x.placements])


def run_segment(seg: Segment, layers, x, cfg, *, positions, state=None,
                mode="train", commit=None, enc_out=None):
    """Apply a homogeneous segment layer by layer; ``state`` (the stacked
    segment state, or None) is updated in place. Returns (x, aux summed
    over the layers, float32 scalars).

    Training with grad enabled and ``cfg.remat`` (the reference's
    ``jax.checkpoint`` around each layer) keeps only each layer's input
    for the backward pass and recomputes the rest of the layer there."""
    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
    aux = _zero_aux(x.device)
    # to a cost recorder, the reference's scan over the layers
    with cost_loop(current_recorder(), len(layers)):
        for i, lp in enumerate(layers):
            x = _sp_constraint(x, cfg)
            kw = dict(positions=positions, is_global=seg.is_global,
                      state=_layer_state(state, i), mode=mode,
                      commit=commit, enc_out=enc_out)
            if remat:
                x, la = checkpoint(apply_layer, seg.kind, lp, x, cfg, **kw,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
            else:
                x, la = apply_layer(seg.kind, lp, x, cfg, **kw)
            if la is not None:
                aux = {k: aux[k] + la[k].float() for k in aux}
    return x, aux


# --------------------------------------------------------------- forward
def forward_hidden(params: LMParams, x, cfg, *, positions, states=None,
                   mode="train", commit=None, enc_out=None):
    """x [B, T, D] embeddings -> (hidden [B, T, D], states, aux). The
    states (if any) are updated in place and returned as given; aux holds
    the MoE losses and overflow summed over the layers (zeros for the
    other families), float32 scalars."""
    aux = _zero_aux(x.device)
    for i, (seg, layers) in enumerate(zip(plan_segments(cfg),
                                          params.segments)):
        st = None if states is None else states[i]
        x, sa = run_segment(seg, layers, x, cfg, positions=positions,
                            state=st, mode=mode, commit=commit,
                            enc_out=enc_out)
        aux = {k: aux[k] + sa[k] for k in aux}
    x = rmsnorm(params.final_norm, _whole_sequence(x), cfg.norm_eps)
    return x, states, aux


def run_encoder(params: LMParams, src_embeds, cfg) -> torch.Tensor:
    """The encoder over ``src_embeds`` [B, S, D] (bidirectional, rope at
    positions 0..S-1) -> enc_out [B, S, D]."""
    x = src_embeds
    pos = torch.arange(src_embeds.shape[1], device=x.device)
    for seg, layers in zip(plan_encoder_segments(cfg), params.enc_segments):
        x, _ = run_segment(seg, layers, x, cfg, positions=pos, mode="train")
    return rmsnorm(params.enc_final_norm, x, cfg.norm_eps)


def logits_head(params: LMParams, hidden, cfg) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = params.embed.table.T
    else:
        w = params.lm_head.w
    return (hidden @ w).float()


# ------------------------------------------------------- streaming states
def init_segment_state(seg: Segment, cfg, batch: int, max_len: int,
                       dtype, device) -> dict[str, Any]:
    """Stacked streaming state for one segment (decode/serving)."""
    L = seg.n_layers
    if seg.kind == "rwkv":
        hd = cfg.hd
        h = cfg.d_model // hd

        def last():
            return torch.zeros((L, batch, 1, cfg.d_model), dtype=dtype,
                               device=device)

        return {"tm": {"last": last(),
                       "s": torch.zeros((L, batch, h, hd, hd),
                                        dtype=torch.float32, device=device)},
                "cm": {"last": last()}}
    kv_dt = DTYPES[cfg.kv_cache_dtype]
    if cfg.kv_cache_dtype == "bfloat16":
        kv_dt = dtype  # follow the param dtype (float32 in tests)
    smax = max_len
    if not seg.is_global and cfg.sliding_window is not None:
        smax = min(max_len, cfg.sliding_window)
    kv = init_kv_cache(batch, cfg.n_kv_heads, smax, cfg.hd, kv_dt, device,
                       n_layers=L)
    if seg.kind == "hymba":
        s = cfg.ssm
        return {"kv": kv,
                "ssm": torch.zeros((L, batch, ssm_heads(cfg), s.head_dim,
                                    s.state_dim), dtype=torch.float32,
                                   device=device)}
    return {"kv": kv}


def init_states(cfg, batch: int, max_len: int, dtype, device):
    return [init_segment_state(s, cfg, batch, max_len, dtype, device)
            for s in plan_segments(cfg)]

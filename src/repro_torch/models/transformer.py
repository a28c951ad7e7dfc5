"""Decoder stack of the dense and ssm (RWKV6) families.

Port of ``repro/models/transformer.py`` for its ``attn`` segments (GQA
attention, optional sliding window and QKV bias, SwiGLU MLP) and its
``rwkv`` segments (RWKV6 time-mix and channel-mix, models/rwkv6.py). The
stack is a list of *segments*, runs of consecutive layers with one block
structure, as in the reference; where the reference scans a segment's
stacked parameters with ``lax.scan``, the port holds one module per layer
(``segments.<i>.<layer>``) and loops over them in Python.

Streaming state keeps the reference's **stacked** layout: every leaf of a
segment's state has a leading layer axis (``k`` [L, B, Hkv, Smax, hd],
``length`` [L, B], ``tm.s`` [L, B, H, hd, hd], ...), so the serving
engine resets or reads a slot with one op per leaf. A layer works on
views of its row of each leaf, and its state writes land in the stacked
tensors in place.

Other layer kinds (``moe``, ``hymba``, the encoder-decoder's
``enc``/``xdec``) raise ``NotImplementedError``: they come with later
slices of the port (ROADMAP.md, queue 1, item 13).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import (
    attention,
    init_attention,
    init_kv_cache,
    map_state,
)
from repro_torch.models.layers import (
    DTYPES,
    Dense,
    dtype_of,
    init_embedding,
    init_rmsnorm,
    init_swiglu,
    rmsnorm,
    swiglu,
)
from repro_torch.models.rwkv6 import (
    init_rwkv_block,
    rwkv_channel_mix,
    rwkv_time_mix,
)

#: the layer kinds the port runs
KINDS = ("attn", "rwkv")
#: the ROADMAP item each kind the port does not run yet belongs to
_LATER = {"moe": "MoE", "hymba": "hymba", "enc": "encoder-decoder",
          "xdec": "encoder-decoder"}


@dataclass(frozen=True)
class Segment:
    kind: str
    n_layers: int
    is_global: bool = True    # full attention (False -> cfg.sliding_window)


def _require_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r}: the port runs the dense and RWKV6 "
            f"families; the {_LATER.get(kind, kind)} family is a later "
            f"slice (ROADMAP.md, queue 1, item 13)")


# --------------------------------------------------------------- planning
def plan_segments(cfg) -> list[Segment]:
    """The reference's segment plan, for every family (the port runs the
    ``attn`` and ``rwkv`` segments)."""
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


# ------------------------------------------------------------------ params
class Layer(nn.Module):
    """One block, its parts named as the reference's per-layer pytree
    keys: ``attn`` — norm1, attn, norm2, mlp; ``rwkv`` — norm1, rwkv,
    norm2."""

    def __init__(self, **parts: nn.Module):
        super().__init__()
        for name, part in parts.items():
            setattr(self, name, part)


class LMParams(nn.Module):
    """The parameter tree: ``embed.table``, ``segments.<i>.<layer>...``,
    ``final_norm.scale`` and, without tied embeddings, ``lm_head.w``."""

    def __init__(self, embed, segments, final_norm, lm_head=None):
        super().__init__()
        self.embed = embed
        self.segments = nn.ModuleList(nn.ModuleList(s) for s in segments)
        self.final_norm = final_norm
        self.lm_head = lm_head


def init_layer(init, cfg, kind: str) -> Layer:
    dt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    if kind == "rwkv":
        return Layer(norm1=init_rmsnorm(init, d, dt),
                     rwkv=init_rwkv_block(init, cfg),
                     norm2=init_rmsnorm(init, d, dt))
    return Layer(norm1=init_rmsnorm(init, d, dt),
                 attn=init_attention(init, cfg),
                 norm2=init_rmsnorm(init, d, dt),
                 mlp=init_swiglu(init, d, cfg.d_ff, dt))


def init_params(cfg, init) -> LMParams:
    dt = dtype_of(cfg.param_dtype)
    segs = plan_segments(cfg)
    for s in segs:
        _require_kind(s.kind)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = Dense(init.normal((cfg.d_model, cfg.vocab), 0.02, dt))
    return LMParams(
        init_embedding(init, cfg.vocab, cfg.d_model, dt),
        [[init_layer(init, cfg, s.kind) for _ in range(s.n_layers)]
         for s in segs],
        init_rmsnorm(init, cfg.d_model, dt),
        lm_head)


# ------------------------------------------------------------ layer apply
def _layer_state(state: dict | None, i: int):
    """Layer i's state: views of row i of the stacked leaves."""
    if state is None:
        return None
    return map_state(lambda x: x[i], state)


def apply_layer(kind: str, lp: Layer, x, cfg, *, positions, is_global,
                state, mode, commit=None):
    """One block of ``kind``; ``state`` (the layer's views, or None) is
    updated in place, only the ``commit`` rows under a mask."""
    if kind == "rwkv":
        st = state or {"tm": None, "cm": None}
        x = x + rwkv_time_mix(lp.rwkv.tm, rmsnorm(lp.norm1, x, cfg.norm_eps),
                              cfg, state=st["tm"], impl=cfg.attn_impl,
                              commit=commit)
        return x + rwkv_channel_mix(lp.rwkv.cm,
                                    rmsnorm(lp.norm2, x, cfg.norm_eps),
                                    state=st["cm"], commit=commit)
    window = None if is_global else cfg.sliding_window
    x = x + attention(lp.attn, rmsnorm(lp.norm1, x, cfg.norm_eps), cfg,
                      positions=positions, causal=True, window=window,
                      cache=None if state is None else state["kv"],
                      mode=mode, commit=commit)
    return x + swiglu(lp.mlp, rmsnorm(lp.norm2, x, cfg.norm_eps))


_ZERO_AUX = {"load_balance_loss": 0.0, "router_z_loss": 0.0,
             "overflow_fraction": 0.0}


def run_segment(seg: Segment, layers, x, cfg, *, positions, state=None,
                mode="train", commit=None):
    """Apply a homogeneous segment layer by layer; ``state`` (the stacked
    segment state, or None) is updated in place.

    Training with grad enabled and ``cfg.remat`` (the reference's
    ``jax.checkpoint`` around each layer) keeps only each layer's input
    for the backward pass and recomputes the rest of the layer there."""
    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
    for i, lp in enumerate(layers):
        kw = dict(positions=positions, is_global=seg.is_global,
                  state=_layer_state(state, i), mode=mode, commit=commit)
        if remat:
            x = checkpoint(apply_layer, seg.kind, lp, x, cfg, **kw,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = apply_layer(seg.kind, lp, x, cfg, **kw)
    return x


# --------------------------------------------------------------- forward
def forward_hidden(params: LMParams, x, cfg, *, positions, states=None,
                   mode="train", commit=None):
    """x [B, T, D] embeddings -> (hidden [B, T, D], states, aux). The
    states (if any) are updated in place and returned as given."""
    for i, (seg, layers) in enumerate(zip(plan_segments(cfg),
                                          params.segments)):
        st = None if states is None else states[i]
        x = run_segment(seg, layers, x, cfg, positions=positions, state=st,
                        mode=mode, commit=commit)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return x, states, dict(_ZERO_AUX)


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
    _require_kind(seg.kind)
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
    smax = max_len
    if not seg.is_global and cfg.sliding_window is not None:
        smax = min(max_len, cfg.sliding_window)
    kv_dt = DTYPES[cfg.kv_cache_dtype]
    if cfg.kv_cache_dtype == "bfloat16":
        kv_dt = dtype  # follow the param dtype (float32 in tests)
    return {"kv": init_kv_cache(batch, cfg.n_kv_heads, smax, cfg.hd, kv_dt,
                                device, n_layers=L)}


def init_states(cfg, batch: int, max_len: int, dtype, device):
    return [init_segment_state(s, cfg, batch, max_len, dtype, device)
            for s in plan_segments(cfg)]

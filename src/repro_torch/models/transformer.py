"""Decoder stack of the dense family.

Port of ``repro/models/transformer.py`` for its ``attn`` segments (GQA
attention, optional sliding window and QKV bias, SwiGLU MLP). The stack
is a list of *segments*, runs of consecutive layers with one block
structure, as in the reference; where the reference scans a segment's
stacked parameters with ``lax.scan``, the port holds one module per layer
(``segments.<i>.<layer>``) and loops over them in Python.

Streaming state keeps the reference's **stacked** layout: every leaf of a
segment's state has a leading layer axis (``k`` [L, B, Hkv, Smax, hd],
``length`` [L, B], ...), so the serving engine resets or reads a slot
with one op per leaf. A layer works on views of its row of each leaf,
and its cache writes land in the stacked tensors in place.

Other layer kinds (``moe``, ``rwkv``, ``hymba``, the encoder-decoder's
``enc``/``xdec``) raise ``NotImplementedError``: they come with later
slices of the port (ROADMAP.md, queue 1, item 13).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch import nn

from repro_torch.models.attention import (
    KVCache,
    attention,
    init_attention,
    init_kv_cache,
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

#: the ROADMAP item each kind the port does not run yet belongs to
_LATER = {"moe": "MoE", "rwkv": "RWKV6 (with the wkv6 kernel)",
          "hymba": "hymba", "enc": "encoder-decoder",
          "xdec": "encoder-decoder"}


@dataclass(frozen=True)
class Segment:
    kind: str
    n_layers: int
    is_global: bool = True    # full attention (False -> cfg.sliding_window)


def _require_attn(kind: str) -> None:
    if kind != "attn":
        raise NotImplementedError(
            f"layer kind {kind!r}: the port runs the dense family only; "
            f"the {_LATER.get(kind, kind)} family is a later slice "
            f"(ROADMAP.md, queue 1, item 13)")


# --------------------------------------------------------------- planning
def plan_segments(cfg) -> list[Segment]:
    """The reference's segment plan, for every family (the port runs the
    ``attn`` segments)."""
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
    """One ``attn`` block: norm1, attn, norm2, mlp (the reference's
    per-layer pytree keys)."""

    def __init__(self, norm1, attn, norm2, mlp):
        super().__init__()
        self.norm1, self.attn, self.norm2, self.mlp = norm1, attn, norm2, mlp


class LMParams(nn.Module):
    """The parameter tree: ``embed.table``, ``segments.<i>.<layer>...``,
    ``final_norm.scale`` and, without tied embeddings, ``lm_head.w``."""

    def __init__(self, embed, segments, final_norm, lm_head=None):
        super().__init__()
        self.embed = embed
        self.segments = nn.ModuleList(nn.ModuleList(s) for s in segments)
        self.final_norm = final_norm
        self.lm_head = lm_head


def init_layer(init, cfg) -> Layer:
    dt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    return Layer(init_rmsnorm(init, d, dt), init_attention(init, cfg),
                 init_rmsnorm(init, d, dt),
                 init_swiglu(init, d, cfg.d_ff, dt))


def init_params(cfg, init) -> LMParams:
    dt = dtype_of(cfg.param_dtype)
    segs = plan_segments(cfg)
    for s in segs:
        _require_attn(s.kind)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = Dense(init.normal((cfg.d_model, cfg.vocab), 0.02, dt))
    return LMParams(
        init_embedding(init, cfg.vocab, cfg.d_model, dt),
        [[init_layer(init, cfg) for _ in range(s.n_layers)]
         for s in segs],
        init_rmsnorm(init, cfg.d_model, dt),
        lm_head)


# ------------------------------------------------------------ layer apply
def _layer_state(state: dict | None, i: int) -> KVCache | None:
    """Layer i's cache: views of row i of the stacked leaves."""
    if state is None:
        return None
    kv = state["kv"]
    return KVCache(kv.k[i], kv.v[i], kv.length[i], kv.kpos[i])


def apply_layer(lp: Layer, x, cfg, *, positions, is_global, cache, mode,
                commit=None):
    """One ``attn`` block (the only kind ``init_params`` builds)."""
    window = None if is_global else cfg.sliding_window
    x = x + attention(lp.attn, rmsnorm(lp.norm1, x, cfg.norm_eps), cfg,
                      positions=positions, causal=True, window=window,
                      cache=cache, mode=mode, commit=commit)
    return x + swiglu(lp.mlp, rmsnorm(lp.norm2, x, cfg.norm_eps))


_ZERO_AUX = {"load_balance_loss": 0.0, "router_z_loss": 0.0,
             "overflow_fraction": 0.0}


def run_segment(seg: Segment, layers, x, cfg, *, positions, state=None,
                mode="train", commit=None):
    """Apply a homogeneous segment layer by layer; ``state`` (the stacked
    segment state, or None) is updated in place."""
    for i, lp in enumerate(layers):
        x = apply_layer(lp, x, cfg, positions=positions,
                        is_global=seg.is_global,
                        cache=_layer_state(state, i), mode=mode,
                        commit=commit)
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
    _require_attn(seg.kind)
    smax = max_len
    if not seg.is_global and cfg.sliding_window is not None:
        smax = min(max_len, cfg.sliding_window)
    kv_dt = DTYPES[cfg.kv_cache_dtype]
    if cfg.kv_cache_dtype == "bfloat16":
        kv_dt = dtype  # follow the param dtype (float32 in tests)
    return {"kv": init_kv_cache(batch, cfg.n_kv_heads, smax, cfg.hd, kv_dt,
                                device, n_layers=seg.n_layers)}


def init_states(cfg, batch: int, max_len: int, dtype, device):
    return [init_segment_state(s, cfg, batch, max_len, dtype, device)
            for s in plan_segments(cfg)]

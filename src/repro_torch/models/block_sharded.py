"""The Megatron-SP transformer block with its schedule written out.

Port of ``repro/models/block_sharded.py`` (the reference's ``shard_map``
becomes ``distributed/spmd.py::shard_map``, its collectives
``distributed/collectives.py``'s):

  residual stream x: [B, T/msz, D]   (T sharded over model between blocks)
  1. all_gather(model, T)   -> x_full [B, T, D]
  2. norm1; qkv with column-sharded weights -> the local q-head subset
     (K/V replicated when Hkv doesn't divide; expanded and sliced
     locally)
  3. chunked attention, entirely local (the head subset)
  4. out-projection row-sharded -> partial [B, T, D]
  5. reduce_scatter(model, T) + residual add
  6. the same all_gather / reduce_scatter pair around the SwiGLU MLP

The weight layouts are ``distributed/sharding.py``'s TP rules, so one
checkpoint serves both paths. Used when ``cfg.tp_shard_map`` is set, in
training without a cache, and the heads divide the model axis
(``models/transformer.py``).
"""
from __future__ import annotations

from types import SimpleNamespace

from torch.nn import functional as F

from repro_torch.distributed.collectives import (
    all_gather,
    axis_group,
    reduce_scatter,
)
from repro_torch.distributed.sharding import (
    P,
    data_axes,
    mesh_axes,
    spec_placements,
)
from repro_torch.distributed.spmd import shard_map
from repro_torch.models.attention import _expand_heads, attention_inner
from repro_torch.models.layers import rmsnorm, rope


def attn_mlp_block_sharded(lp, x, cfg, *, positions, window, mesh):
    """One pre-norm attention + SwiGLU layer under manual SP. x [B, T, D]
    (placed T-sharded over model on entry); returns the same layout.
    ``lp``: the standard layer (norm1, attn, norm2, mlp)."""
    msz = mesh_axes(mesh).get("model", 1)
    dax = data_axes(mesh)
    bspec = (dax if len(dax) > 1 else dax[0]) if dax else None
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if hq % msz:
        raise ValueError(f"tp_shard_map needs q-heads ({hq}) % model "
                         f"({msz}) == 0")
    h_loc = hq // msz
    kv_sharded = hkv % msz == 0
    g_model = axis_group(mesh, "model") if msz > 1 else None
    midx = mesh.get_local_rank("model") if msz > 1 else 0

    def gather_t(z):
        return all_gather(z, g_model, 1) if msz > 1 else z

    def scatter_t(z):
        return reduce_scatter(z, g_model, 1) if msz > 1 else z

    def fn(xs, n1, wq, wk, wv, wo, n2, wg, wu, wdn):
        b = xs.shape[0]
        # ---- SP: gather the full sequence ----
        xf = gather_t(xs)                                    # [B, T, D]
        t = xf.shape[1]
        h = rmsnorm(SimpleNamespace(scale=n1), xf, cfg.norm_eps)
        q = (h @ wq).reshape(b, t, h_loc, hd)
        k = (h @ wk).reshape(b, t, -1, hd)
        v = (h @ wv).reshape(b, t, -1, hd)
        q = rope(q, positions[:t], cfg.rope_theta).transpose(1, 2)
        k = rope(k, positions[:t], cfg.rope_theta).transpose(1, 2)
        v = v.transpose(1, 2)
        if not kv_sharded:
            # K/V replicated: expand to all q heads, take this rank's span
            k, v = (_expand_heads(z, hq // hkv, midx * h_loc, h_loc)
                    for z in (k, v))
        o = attention_inner(q, k, v, causal=True, window=window,
                            impl="chunked", chunk=cfg.attn_chunk)
        o = o.transpose(1, 2).reshape(b, t, h_loc * hd)
        # ---- SP: reduce_scatter back to T-shards + residual ----
        xs = xs + scatter_t(o @ wo).to(xs.dtype)
        # ---- MLP with the same pair ----
        h2 = rmsnorm(SimpleNamespace(scale=n2), gather_t(xs),
                     cfg.norm_eps)
        act = F.silu(h2 @ wg) * (h2 @ wu)
        return xs + scatter_t(act @ wdn).to(xs.dtype)

    def pl(*spec):
        return spec_placements(P(*spec), mesh)

    kv = pl(None, "model") if kv_sharded else pl(None, None)
    return shard_map(
        fn, mesh,
        in_placements=(pl(bspec, "model", None),    # x: T-sharded
                       pl(None),                    # norm1 scale
                       pl(None, "model"),           # wq col-sharded
                       kv, kv,                      # wk, wv
                       pl("model", None),           # wo row-sharded
                       pl(None),                    # norm2 scale
                       pl(None, "model"),           # w_gate
                       pl(None, "model"),           # w_up
                       pl("model", None)),          # w_down
        out_placements=pl(bspec, "model", None),
    )(x, lp.norm1.scale, lp.attn.wq.w, lp.attn.wk.w, lp.attn.wv.w,
      lp.attn.wo.w, lp.norm2.scale, lp.mlp.w_gate.w, lp.mlp.w_up.w,
      lp.mlp.w_out.w)

"""GQA attention with three interchangeable inner implementations.

Port of ``repro/models/attention.py``:

  "ref"     — materialized [T, S] logits (kernels/flash/ref.py)
  "chunked" — flash-style loop over query chunks with *structural*
              sliding-window KV slicing: each chunk reads only the KV it
              can see (plain PyTorch)
  "pallas"  — the fused kernel (kernels/flash): the hand-written CUDA
              kernel for tensors on the card, its plain version on the
              CPU. The name is the reference's, so one config selects the
              fused kernel in both packages.

All three share semantics: causal masking, sliding window, GQA head
grouping, end-alignment when S > T.

KV cache: a *ring buffer* of capacity Smax with absolute-position tracking
(``kpos``); for sliding-window layers Smax = window. Unlike the
reference, whose cache updates return new arrays, the port writes the
ring **in place** (``_ring_update``), and only the rows a ``commit`` mask
names: a decode step computed for every slot of a batch advances only the
slots of the wave, and leaves every other slot's ``k``, ``v``, ``length``
and ``kpos`` as they were — the reference's masked merge, without copying
the cache.

A decode or chunk step attends over the ring and its own fresh keys,
masked by absolute position, and writes the ring afterwards (the
reference writes first). Every row, committed or not, then attends as
the reference's rows do before its merge; an idle row's output matters
where a MoE layer routes it beside the others. A decode step sees the
reference's keys. A chunk step that wraps a window ring also keeps the
keys its first queries still see, which the reference's ring has
already overwritten: past the window its chunked prefill equals one-shot
prefill, where the reference's does not.

Cross-attention (the encoder-decoder's ``xdec`` layers): ``kv_input``
gives K/V, no rope, no mask, no cache.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.distributed.spmd import (
    mesh_coordinate,
    run_local,
    split_along,
)
from repro_torch.kernels.flash.ops import flash_attention
from repro_torch.kernels.flash.ref import attention_ref
from repro_torch.models.layers import Dense, dense, dtype_of, init_dense, rope


class KVCache(NamedTuple):
    k: torch.Tensor          # [B, Hkv, Smax, hd]
    v: torch.Tensor
    length: torch.Tensor     # [B] int32 — absolute tokens seen, per request
    kpos: torch.Tensor       # [B, Smax] int32 — absolute position per slot


def map_state(fn, tree, is_leaf=None):
    """``tree`` with ``fn`` applied to every tensor leaf (and to every node
    that ``is_leaf`` accepts); dicts, lists and ``KVCache``s keep their
    structure. The one walker of the serving state trees."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_state(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, KVCache):
        return KVCache(*(fn(x) for x in tree))
    if isinstance(tree, list):
        return [map_state(fn, v, is_leaf) for v in tree]
    return fn(tree)


def state_leaves(tree) -> list[torch.Tensor]:
    """The tensor leaves of a state tree, in ``map_state``'s order."""
    leaves: list[torch.Tensor] = []
    map_state(leaves.append, tree)
    return leaves


def init_kv_cache(batch, n_kv_heads, smax, head_dim, dtype, device,
                  *, n_layers: int | None = None) -> KVCache:
    """An empty ring; with ``n_layers`` every leaf gets a leading layer
    axis (the stacked state layout of ``transformer.init_segment_state``)."""
    lead = () if n_layers is None else (n_layers,)
    return KVCache(
        k=torch.zeros(lead + (batch, n_kv_heads, smax, head_dim),
                      dtype=dtype, device=device),
        v=torch.zeros(lead + (batch, n_kv_heads, smax, head_dim),
                      dtype=dtype, device=device),
        length=torch.zeros(lead + (batch,), dtype=torch.int32,
                           device=device),
        kpos=torch.full(lead + (batch, smax), -1, dtype=torch.int32,
                        device=device),
    )


class Attention(nn.Module):
    def __init__(self, wq: Dense, wk: Dense, wv: Dense, wo: Dense):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


def init_attention(init, cfg, *, d_model=None, cross=False) -> Attention:
    """The four projections. ``cross`` (the decoder's cross-attention)
    takes the same shapes, as in the reference: its K/V read the encoder's
    output, of width d_model too."""
    d = d_model or cfg.d_model
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = dtype_of(cfg.param_dtype)
    return Attention(
        init_dense(init, d, hq * hd, dt, bias=cfg.qkv_bias),
        init_dense(init, d, hkv * hd, dt, bias=cfg.qkv_bias),
        init_dense(init, d, hkv * hd, dt, bias=cfg.qkv_bias),
        init_dense(init, hq * hd, d, dt,
                   scale=(hq * hd) ** -0.5 / (2 * cfg.n_layers) ** 0.5))


# ----------------------------------------------------------- inner impls
def _attn_chunked(q, k, v, *, causal, window, scale, chunk,
                  gqa_expand=False):
    """Online-softmax attention over query chunks, GQA-aware.

    q [B, H, T, hd]; k, v [B, Hkv, S, hd]. With ``window`` set each query
    chunk reads only the KV slice it can see. ``gqa_expand`` repeats KV
    per q-head first (the reference's sharding knob; same result).
    """
    b, h, t, hd = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = h // hkv
    if gqa_expand and group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
        hkv, group = h, 1
    bq = min(chunk, t)
    while t % bq:       # prefix tokens can make t a non-power-of-two
        bq //= 2
    bq = max(bq, 1)
    n_chunks = t // bq
    seq_off = s - t     # end alignment
    qg = q.reshape(b, hkv, group, t, hd)
    kv_span = s if window is None else min(s, window + bq)

    outs = []
    for ci in range(n_chunks):
        q0 = ci * bq
        qc = qg[:, :, :, q0:q0 + bq]
        k0 = 0 if window is None else min(max(q0 + seq_off + bq - kv_span,
                                              0), s - kv_span)
        kc = k[:, :, k0:k0 + kv_span]
        vc = v[:, :, k0:k0 + kv_span]
        logits = torch.einsum("bkgtd,bksd->bkgts", qc.float(),
                              kc.float()) * scale
        qpos = q0 + seq_off + torch.arange(bq, device=q.device)[:, None]
        kpos = k0 + torch.arange(kv_span, device=q.device)[None, :]
        mask = torch.ones((bq, kv_span), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        logits = torch.where(mask, logits, -1e30)
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.exp(logits - m)
        lsum = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bkgts,bksd->bkgtd", p, vc.float())
        outs.append((o / lsum.clamp(min=1e-30)).to(q.dtype))
    out = outs[0] if n_chunks == 1 else torch.cat(outs, dim=3)
    return out.reshape(b, h, t, hd)


def attention_inner(q, k, v, *, causal=True, window=None, scale=None,
                    impl="chunked", chunk=256, gqa_expand=False):
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "ref":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale)
    if impl == "pallas":
        return flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)
    return _attn_chunked(q, k, v, causal=causal, window=window, scale=scale,
                         chunk=chunk, gqa_expand=gqa_expand)


def _attn_cache(q, k_new, v_new, cache: KVCache, *, causal=True,
                window=None):
    """Attention of q [B, H, T, hd], the tokens at positions ``length ..
    length + T - 1``, over the ring's keys and the T fresh ones k_new /
    v_new [B, Hkv, T, hd], the ring not yet written; masking by absolute
    positions (kpos, per request). Materialized [T, Smax + T] logits —
    used for decode (T == 1) and chunked-prefill steps. The fresh keys
    are rounded to the cache's dtype first, as the ring would hold them."""
    b, h, t, hd = q.shape
    hkv, smax = cache.k.shape[1], cache.k.shape[2]
    qg = q.reshape(b, hkv, h // hkv, t, hd).float()
    k_new = k_new.to(cache.k.dtype).float()
    v_new = v_new.to(cache.v.dtype).float()
    logits = torch.cat(
        [torch.einsum("bkgtd,bksd->bkgts", qg, cache.k.float()),
         torch.einsum("bkgtd,bksd->bkgts", qg, k_new)], dim=-1) * (hd ** -0.5)
    qpos = (cache.length[:, None]
            + torch.arange(t, device=q.device, dtype=torch.int32))  # [B, T]
    kpos = torch.cat([cache.kpos, qpos], dim=1)[:, None, :]  # [B, 1, S + T]
    qpos = qpos[:, :, None]                                       # [B, T, 1]
    mask = kpos >= 0
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    logits = torch.where(mask[:, None, None], logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    o = (torch.einsum("bkgts,bksd->bkgtd", p[..., :smax], cache.v.float())
         + torch.einsum("bkgts,bksd->bkgtd", p[..., smax:], v_new))
    return o.reshape(b, h, t, hd).to(q.dtype)


def _raw(dst: torch.Tensor) -> torch.Tensor:
    """The cache tensor itself, or its bytes for a float8 cache (indexed
    writes and selects go through the bytes)."""
    return dst.view(torch.uint8) if dst.dtype == torch.float8_e4m3fn else dst


def _stored(dst: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the cache's dtype, in ``_raw(dst)``'s view."""
    return _raw(x.to(dst.dtype))


def _ring_update(cache: KVCache, k_new, v_new,
                 commit: Optional[torch.Tensor] = None) -> None:
    """Write t new timesteps into the ring buffer in place, at per-request
    offsets: token ``length + i`` goes to slot ``(length + i) % Smax``,
    ``kpos`` records its position and ``length`` advances by t; of more
    than Smax, only the last Smax are written (the older ones could never
    be attended again). k_new [B, Hkv, t, hd]. ``commit`` ([B] bool, None
    = all) names the rows that advance: the others keep their ring
    unchanged."""
    b, _, t, _ = k_new.shape
    smax = cache.k.shape[2]
    if t > smax:
        skipped = t - smax
        cache.length.add_(skipped if commit is None
                          else commit.to(torch.int32) * skipped)
        k_new, v_new, t = k_new[:, :, skipped:], v_new[:, :, skipped:], smax
    pos = (cache.length[:, None]
           + torch.arange(t, device=k_new.device, dtype=torch.int32))
    slots = (pos % smax).long()                                   # [B, t]
    rows = torch.arange(b, device=k_new.device)[:, None].expand(b, t)
    at = (rows, slice(None), slots)           # -> [B, t, Hkv, hd] values
    for dst, new in ((cache.k, k_new), (cache.v, v_new)):
        raw, new = _raw(dst), _stored(dst, new.transpose(1, 2))
        if commit is not None:
            new = torch.where(commit[:, None, None, None], new, raw[at])
        raw[at] = new
    if commit is None:
        cache.kpos[rows, slots] = pos
        cache.length.add_(t)
    else:
        cache.kpos[rows, slots] = torch.where(commit[:, None], pos,
                                              cache.kpos[rows, slots])
        cache.length.add_(commit.to(torch.int32) * t)


# ------------------------------------------------------------- full layer
def attention(params: Attention, x, cfg, *, positions, causal=True,
              window=None, cache: Optional[KVCache] = None, kv_input=None,
              mode: str = "train", commit: Optional[torch.Tensor] = None):
    """x [B, T, D]. Returns out [B, T, D]; the cache is updated in place.
    ``kv_input`` [B, S, D]: the cross-attention's source (K and V are
    projected from it; default x); with ``positions=None`` no rope.

    mode: "train" (no cache) | "prefill" (attention over the fresh k/v via
    ``cfg.attn_impl``) | "decode" / "chunk" (attention over the cache and
    the fresh k/v); with a cache, the fresh k/v are then written into the
    ring. ``commit`` ([B] bool) limits the ring update to those rows
    (decode).
    """
    b, t, d = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    src = x if kv_input is None else kv_input
    s = src.shape[1]

    q = dense(params.wq, x).reshape(b, t, hq, hd)
    k = dense(params.wk, src).reshape(b, s, hkv, hd)
    v = dense(params.wv, src).reshape(b, s, hkv, hd)

    # under a mesh the heads are each rank's (local_map); q's heads split
    # over "model" while K/V stay whole (Hkv does not divide): every rank
    # expands K/V to the q heads and takes its own
    if cache is not None and split_along(cache.k, "model") == 2:
        raise NotImplementedError(
            "attention over a ring sharded along its sequence "
            "(seq_shard_cache) is not ported: the dry run places such "
            "states, no step runs on them")
    head0 = None
    if split_along(q, "model") == 2 and split_along(k, "model") != 2:
        m, msz = mesh_coordinate(q, "model")
        head0 = m * (hq // msz)
    o = run_local(_attend, q, (q, k, v, positions, cache, commit),
                  out_placements=None, cfg=cfg, causal=causal,
                  window=window, mode=mode, group=hq // hkv, head0=head0)
    return dense(params.wo, o.reshape(b, t, hq * hd))


def _expand_heads(k, group: int, head0: int, n: int):
    """K/V [B, Hkv, S, hd] -> the ``n`` q heads from ``head0`` on."""
    return k.repeat_interleave(group, dim=1)[:, head0:head0 + n]


def _attend(q, k, v, positions, cache, commit, *, cfg, causal, window,
            mode, group, head0):
    """The per-head part of ``attention``: rope, the inner attention (or
    the ring's) and the ring update, on q [B, T, H, hd], k/v
    [B, S, Hkv, hd] -> o [B, T, H, hd]. On a rank of a mesh the tensors
    are its local shards; ``head0`` (not None when K/V are whole while q
    holds heads ``head0 ..``) expands K/V to those heads."""
    s = k.shape[1]
    if positions is not None:                   # rope (self-attention only)
        q = rope(q, positions, cfg.rope_theta)
        kpos = positions if cache is None else (
            cache.length[:, None]
            + torch.arange(s, device=q.device, dtype=torch.int32)[None, :])
        k = rope(k, kpos, cfg.rope_theta)

    q = q.transpose(1, 2)                       # [B, H, T, hd]
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    ka, va, ring = k, v, cache
    if head0 is not None:
        n = q.shape[1]
        ka, va = (_expand_heads(z, group, head0, n) for z in (k, v))
        if cache is not None:
            ring = cache._replace(
                k=_expand_heads(cache.k, group, head0, n),
                v=_expand_heads(cache.v, group, head0, n))

    if cache is not None and mode != "prefill":     # decode / chunk
        o = _attn_cache(q, ka, va, ring, causal=causal, window=window)
    else:
        o = attention_inner(q, ka, va, causal=causal, window=window,
                            impl=cfg.attn_impl, chunk=cfg.attn_chunk,
                            gqa_expand=cfg.gqa_expand)
    if cache is not None:
        _ring_update(cache, k, v, commit)
    return o.transpose(1, 2)

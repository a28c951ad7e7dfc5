"""Expert-parallel MoE with its schedule written out.

Port of ``repro/models/moe_sharded.py``: the reference's ``shard_map``
becomes ``distributed/spmd.py::shard_map`` on the parameters' DTensors,
its collectives ``distributed/collectives.py``'s (differentiable and
counted). The schedule, per layer:

  tokens: sharded over the data axes; replicated over model
  w_gate/w_up: [E→data, D→model, Fe]   w_out: [E→data, Fe, D→model]

  1. local top-k / sort / capacity  -> buf [E, C_loc, D_loc]
     (each model rank dispatches only its D-slice)
  2. all_to_all over data           -> buf' [E_loc, dsz·C_loc, D_loc]
  3. h = buf' ·_D w_gate (partial over D) --psum(model, bfloat16)-->
     silu gating local
  4. y = act · w_out      -> [rows, D_loc]
  5. reverse all_to_all over data   -> [E, C_loc, D_loc]
  6. local gate-weighted combine -> out [N_loc, D_loc]
     --all_gather(model)--> [N_loc, D]

``moe_impl="shard_map_wg"`` gathers the layer's expert weights over model
instead and regroups the dispatch rows over model with a second
all_to_all, so each model rank runs full-D products on 1/msz of the rows
(no psum).

The capacity is the local batch's, ``int(N_loc·k/E·cf) + 1`` (rounded up
to a multiple of msz for ``shard_map_wg``), so which pairs are dropped
differs from the dense dispatch's over the whole batch; the aux terms are
the per-shard values averaged over the data axes (the reference's
``pmean``), and the bfloat16 sum of ``h`` and ``u`` rounds: the layer
equals the reference's sharded layer, not the dense one.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from repro_torch.distributed.collectives import (
    all_gather,
    all_to_all,
    axis_group,
    pmean,
    psum,
)
from repro_torch.distributed.sharding import (
    P,
    data_axes,
    data_size,
    mesh_axes,
    spec_placements,
)
from repro_torch.distributed.spmd import shard_map
from repro_torch.models.layers import swiglu
from repro_torch.models.moe import expert_counts


def _local_dispatch(xd, probs, k: int, e: int, cap: int):
    """xd [N, Dl]; probs [N, E] -> (buf [E, cap, Dl], se, st, sg, keep,
    rank): the (expert, token, gate) pairs sorted by expert, reused by the
    combine."""
    n = xd.shape[0]
    gates, choice = torch.topk(probs, k, dim=-1)             # [N, k]
    gates = gates / gates.sum(dim=-1, keepdim=True)
    flat_e = choice.reshape(-1)
    flat_t = torch.arange(n, device=xd.device).repeat_interleave(k)
    flat_g = gates.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    counts = expert_counts(se, e)
    starts = torch.cumsum(counts, dim=0) - counts
    rank = torch.arange(n * k, device=xd.device) - starts[se]
    keep = rank < cap
    slot = torch.where(keep, rank, cap)
    buf = torch.zeros((e, cap + 1, xd.shape[1]), dtype=xd.dtype,
                      device=xd.device)
    buf = buf.index_put((se, slot), xd[st], accumulate=True)
    return buf[:, :cap], se, st, sg, keep, rank


def moe_layer_sharded(p, x, cfg, mesh):
    """Drop-in for ``moe_layer`` under ``mesh`` (a ``DeviceMesh``). x
    [B, S, D], batch over the data axes, replicated over model (placed so
    on entry). The expert weights are placed as the shard_map layout
    (``sharding.py`` gives it when ``cfg.moe_impl`` is a shard_map one).
    Returns (out [B, S, D], aux) as ``moe_layer``."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    sizes = mesh_axes(mesh)
    dax = data_axes(mesh)
    dsz = data_size(mesh)
    msz = sizes.get("model", 1)
    n_loc = (b * s) // dsz
    cap = int(n_loc * k / e * m.capacity_factor) + 1
    if cfg.moe_impl == "shard_map_wg" and msz > 1:
        # rows regrouped over model: dsz·cap must split msz ways
        cap = -(-cap // msz) * msz
    dl = d // msz
    weight_gathered = cfg.moe_impl == "shard_map_wg"
    bspec = (dax if len(dax) > 1 else dax[0]) if dax else None
    g_data = axis_group(mesh, dax) if dsz > 1 else None
    g_model = axis_group(mesh, "model") if msz > 1 else None
    midx = mesh.get_local_rank("model") if msz > 1 else 0

    def fn(x_loc, rw, wg_l, wu_l, wo_l):
        nl = x_loc.shape[0] * x_loc.shape[1]
        xf = x_loc.reshape(nl, d)
        logits = xf.float() @ rw                               # [Nl, E]
        probs = torch.softmax(logits, dim=-1)
        xd = xf[:, midx * dl:(midx + 1) * dl] if msz > 1 else xf
        buf, se, st, sg, keep, rank = _local_dispatch(xd, probs, k, e, cap)

        # ---- EP all-to-all over the data axes ----
        if dsz > 1:
            buf = all_to_all(buf, g_data, 0, 1)   # [E/dsz, dsz·cap, Dl]
        if weight_gathered and msz > 1:
            wg_f = all_gather(wg_l, g_model, 1)
            wu_f = all_gather(wu_l, g_model, 1)
            wo_f = all_gather(wo_l, g_model, 2)
            rows = all_to_all(buf, g_model, 1, 2)
            h = torch.einsum("ecd,edf->ecf", rows.float(), wg_f.float())
            u = torch.einsum("ecd,edf->ecf", rows.float(), wu_f.float())
            act = F.silu(h) * u
            y = torch.einsum("ecf,efd->ecd", act.to(x_loc.dtype), wo_f)
            y = all_to_all(y, g_model, 2, 1)        # back to [.., C', Dl]
        else:
            # ---- expert products (contraction over model-sharded D) ----
            h = torch.einsum("ecd,edf->ecf", buf.float(), wg_l.float())
            u = torch.einsum("ecd,edf->ecf", buf.float(), wu_l.float())
            if msz > 1:
                h = psum(h.to(torch.bfloat16), g_model)
                u = psum(u.to(torch.bfloat16), g_model)
            act = F.silu(h.float()) * u.float()
            y = torch.einsum("ecf,efd->ecd", act.to(x_loc.dtype), wo_l)

        # ---- reverse all-to-all + local combine ----
        if dsz > 1:
            y = all_to_all(y, g_data, 1, 0)               # [E, cap, Dl]
        contrib = y[se, torch.where(keep, rank, 0)]
        contrib = torch.where(keep[:, None], contrib, 0.0)
        out = torch.zeros((nl, dl), dtype=y.dtype, device=y.device
                          ).index_add(0, st, contrib * sg[:, None].to(y.dtype))
        if msz > 1:
            out = all_gather(out, g_model, 1)

        # ---- aux metrics (as moe.py's) ----
        me = probs.mean(dim=0)
        ce = expert_counts(se, e).float() / nl
        lb = e * torch.sum(me * ce) / k
        z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
        ov = 1.0 - keep.float().mean()
        aux = torch.stack([lb, z, ov])
        if dsz > 1:
            aux = pmean(aux, g_data)
        return out.reshape(x_loc.shape), aux

    def pl(*spec):
        return spec_placements(P(*spec), mesh)

    out, aux = shard_map(
        fn, mesh,
        in_placements=(pl(bspec, None, None),
                       pl(None, None),                 # router replicated
                       pl(bspec, "model", None),       # w_gate [E, D, Fe]
                       pl(bspec, "model", None),       # w_up
                       pl(bspec, None, "model")),      # w_out [E, Fe, D]
        out_placements=(pl(bspec, None, None), pl(None)),
    )(x, p.router.w, p.experts.w_gate, p.experts.w_up, p.experts.w_out)

    aux_d = {"load_balance_loss": aux[0], "router_z_loss": aux[1],
             "overflow_fraction": aux[2]}
    if m.dense_parallel:
        out = out + swiglu(p.dense_mlp, x)
    return out, aux_d

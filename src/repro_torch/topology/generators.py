"""Contact-network generators, all returning padded-CSR Topology.

Port of ``repro/topology/generators.py``: the same edge lists and the same
random draws (``repro_torch.utils.prng`` reproduces ``jax.random``), built
on ``device`` through ``graph.from_edges``, so a generator called with the
same key yields the reference's neighbor table exactly. Nothing allocates
[n, n].

Conventions: undirected simple graphs (no self loops, no multi-edges);
neighbor rows ascend by node id; padding id is -1 (graph.PAD).

``erdos_renyi`` and ``barabasi_albert`` are not ported yet (tests carry
the reference's graphs across through ``bridge.topology_from_numpy``).
"""
from __future__ import annotations

import torch

from repro_torch.topology.graph import (
    Topology,
    _check_dense,
    from_adjacency,
    from_edges,
)
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device

__all__ = ["ring", "lattice2d", "watts_strogatz", "connect_isolated",
           "complete"]


def connect_isolated(topo: Topology, key: torch.Tensor) -> Topology:
    """Attach every isolated node to one uniformly-random other node (on
    the topology's device)."""
    n, dev = topo.n_nodes, topo.device
    v = torch.arange(n, dtype=torch.int32, device=dev)
    iso = topo.degrees == 0
    partner = prng.randint(key.to(dev), (n,), 0, n - 1)
    partner = torch.where(partner >= v, partner + 1, partner)
    edges, valid = topo.edge_list()
    patch = torch.stack([v, torch.where(iso, partner, -1)], dim=1)
    return from_edges(n, torch.cat([edges, patch]),
                      valid=torch.cat([valid, iso]), device=dev)


def ring(n: int, k: int, *, device=None) -> Topology:
    """Ring lattice: node v connects to v +/- 1..k/2 (mod n). k even."""
    if not (k % 2 == 0 and 0 < k < n):
        raise ValueError("need even k with 0 < k < n")
    dev = resolve_device(device)
    half = k // 2
    v = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    steps = torch.arange(1, half + 1, dtype=torch.int64, device=dev)
    nbrs = (v + torch.cat([steps, -steps])[None, :]) % n
    nbrs = torch.sort(nbrs, dim=1).values
    deg = torch.full((n,), k, dtype=torch.int32, device=dev)
    return Topology(neighbors=nbrs.to(torch.int32), degrees=deg, ring_k=k)


def lattice2d(height: int, width: int, *, neighborhood: str = "von_neumann",
              periodic: bool = True, device=None) -> Topology:
    """2D grid, row-major node ids. von_neumann = 4-neighborhood,
    moore = 8-neighborhood; periodic wraps at the edges (torus)."""
    if neighborhood == "von_neumann":
        offs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    elif neighborhood == "moore":
        offs = [(dr, dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1)
                if (dr, dc) != (0, 0)]
    else:
        raise ValueError(f"unknown neighborhood {neighborhood!r}")
    dev = resolve_device(device)
    rows = torch.arange(height, dtype=torch.int64, device=dev)[:, None]
    cols = torch.arange(width, dtype=torch.int64, device=dev)[None, :]
    nbr_list, mask_list = [], []
    for dr, dc in offs:
        rr, cc = rows + dr, cols + dc
        if periodic:
            valid = torch.ones((height, width), dtype=torch.bool, device=dev)
        else:
            valid = (rr >= 0) & (rr < height) & (cc >= 0) & (cc < width)
        rr, cc = rr % height, cc % width
        nbr_list.append((rr * width + cc).reshape(-1))
        mask_list.append(valid.expand(height, width).reshape(-1))
    n = height * width
    src = torch.arange(n, dtype=torch.int64, device=dev)[:, None].expand(
        n, len(offs))
    dst = torch.stack(nbr_list, dim=1)
    mask = torch.stack(mask_list, dim=1)
    edges = torch.stack([src.reshape(-1), dst.reshape(-1)], dim=1)
    return from_edges(n, edges, valid=mask.reshape(-1),
                      max_degree=len(offs), device=dev)


def watts_strogatz(n: int, k: int, beta: float, key: torch.Tensor, *,
                   max_degree: int | None = None, device=None) -> Topology:
    """Small-world rewiring of a ring-k lattice (Watts & Strogatz 1998).

    Each clockwise edge (v, v+j), j = 1..k/2, is rewired with probability
    beta to (v, u) with u uniform != v. A rewire that lands on an existing
    edge is dropped, so degrees may vary around k. max_degree defaults to
    the tight bound.
    """
    if not (k % 2 == 0 and 0 < k < n):
        raise ValueError("need even k with 0 < k < n")
    dev = resolve_device(device)
    half = k // 2
    k_rew, k_tgt = prng.split(key.to(dev)).unbind(0)
    v = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    j = torch.arange(1, half + 1, dtype=torch.int64, device=dev)[None, :]
    beta32 = torch.tensor(beta, dtype=torch.float32, device=dev)
    rewire = prng.uniform(k_rew, (n, half)) < beta32
    u = prng.randint(k_tgt, (n, half), 0, n - 1).to(torch.int64)
    u = torch.where(u >= v, u + 1, u)                        # uniform != v
    tgt = torch.where(rewire, u, (v + j) % n)                # [n, half]
    edges = torch.stack([v.expand(n, half).reshape(-1), tgt.reshape(-1)],
                        dim=1)
    return from_edges(n, edges, max_degree=max_degree, device=dev)


def complete(n: int, *, device=None) -> Topology:
    """Complete graph K_n (the seed Axelrod mixing assumption). Inherently
    dense — the table alone is [n, n-1] — so it stays on the
    ``from_adjacency`` diagnostics path and its size guard (checked before
    the [n, n] argument is allocated)."""
    _check_dense(n, "complete()")
    dev = resolve_device(device)
    return from_adjacency(torch.ones((n, n), dtype=torch.bool, device=dev),
                          max_degree=n - 1, device=dev)

"""Contact-network generators, all returning padded-CSR Topology.

Port of ``repro/topology/generators.py``: the same edge lists and the same
random draws (``repro_torch.utils.prng`` reproduces ``jax.random``), built
on ``device`` through ``graph.from_edges``, so a generator called with the
same key yields the reference's neighbor table exactly. Nothing allocates
[n, n].

Conventions: undirected simple graphs (no self loops, no multi-edges);
neighbor rows ascend by node id; padding id is -1 (graph.PAD).

``erdos_renyi`` draws its edge count with ``prng.binomial`` (the
reference's ``jax.random.binomial``) and keeps the first distinct pairs of
a candidate stream. ``barabasi_albert``'s arrivals are sequential (the
reference's ``lax.scan``): on the card they run in the hand-written
attachment kernel (``kernels/attach``), on the CPU through its plain
version.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.attach import attach_arrivals
from repro_torch.topology.graph import (
    Topology,
    _check_dense,
    from_adjacency,
    from_edges,
)
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device

__all__ = ["ring", "lattice2d", "watts_strogatz", "erdos_renyi",
           "barabasi_albert", "complete", "connect_isolated"]


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


def erdos_renyi(n: int, p: float, key: torch.Tensor, *,
                max_degree: int | None = None, device=None) -> Topology:
    """Sparse Erdos-Renyi: edge count E ~ Binomial(n(n-1)/2, p), then the
    first E *distinct* pairs of a uniform candidate stream (sequential
    draw-ignore-repeats is uniform sampling without replacement, so this
    realizes G(n, p)). O(E log E); nothing is [n, n]. E stays a device
    scalar: no host sync beyond ``from_edges``'s.
    """
    dev = resolve_device(device)
    key = key.to(dev)
    n_pairs = n * (n - 1) // 2
    mean = n_pairs * p
    # target unique count: mean + 6 sigma covers the binomial tail (the
    # reference's host arithmetic, in doubles)
    target = mean + 6.0 * math.sqrt(max(mean * (1.0 - p), 1.0)) + 16
    target = min(target, float(n_pairs)) if n_pairs else 1.0
    p32 = torch.full((), p, dtype=torch.float32, device=dev)
    if target >= 0.98 * n_pairs:
        # near-complete regime: enumerate the pairs and Bernoulli each
        i, j = torch.triu_indices(n, n, 1, device=dev)
        live = prng.uniform(key, (n_pairs,)) < p32
        edges = torch.stack([torch.where(live, i, -1), j], dim=1)
        return from_edges(n, edges, max_degree=max_degree, device=dev)
    # candidate stream sized by the coupon-collector expectation of draws
    # needed to see `target` distinct pairs
    frac = target / n_pairs
    cap = int(-n_pairs * math.log1p(-frac) * 1.05 + 64)
    k_cnt, k_a, k_b = prng.split(key, 3).unbind(0)
    e = prng.binomial(k_cnt, float(n_pairs), p32).to(torch.int32)
    a = prng.randint(k_a, (cap,), 0, n).to(torch.int64)
    b = prng.randint(k_b, (cap,), 0, n - 1).to(torch.int64)
    b = torch.where(b >= a, b + 1, b)         # uniform over ordered pairs
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    # first occurrence of each pair in *draw order*: the reference's
    # lexsort((idx, hi, lo)) is a stable sort of lo·n + hi (< 2^62)
    order = torch.sort(lo * n + hi, stable=True).indices
    ls, lh = lo[order], hi[order]
    head = torch.ones(cap, dtype=torch.bool, device=dev)
    head[1:] = (ls[1:] != ls[:-1]) | (lh[1:] != lh[:-1])
    first = torch.zeros(cap, dtype=torch.bool, device=dev)
    first[order] = head
    live = first & (torch.cumsum(first, 0) - 1 < e)  # first e distinct
    edges = torch.stack([torch.where(live, lo, -1), hi], dim=1)
    return from_edges(n, edges, max_degree=max_degree, device=dev)


def barabasi_albert(n: int, m: int, key: torch.Tensor, *,
                    max_degree: int | None = None, chunk: int | None = None,
                    device=None) -> Topology:
    """Preferential attachment (Barabasi & Albert 1999): a complete seed of
    m+1 nodes; each arriving node t attaches to m distinct nodes drawn
    from the edge-endpoint multiset ``ends`` (probability proportional to
    degree, duplicates rejected), its draws keyed by ``fold_in(key, t)``.

    ``chunk=None`` is the exact sequential realization: the multiset grows
    after every arrival. ``chunk=C`` freezes the multiset per block of C
    arrivals after an exact warm-up of the first C. Either is one launch
    of the attachment kernel on the card, which resolves each arrival as
    soon as the earlier targets it drew are known. The last block may hold
    phantom arrivals (t >= n): they draw and write slab entries past the
    fill that are never read, and their edges are dropped. ``chunk=1``
    equals ``chunk=None``.
    """
    if not 1 <= m < n:
        raise ValueError("need 1 <= m < n")
    dev = resolve_device(device)
    seed_sz = m + 1
    si, sj = torch.triu_indices(seed_sz, seed_sz, 1, device=dev)
    tgts, _ = attachment(n, m, key.to(dev), chunk=chunk)
    ts = torch.arange(seed_sz, seed_sz + tgts.shape[0], dtype=torch.int64,
                      device=dev).repeat_interleave(m)
    new_edges = torch.stack([ts, tgts.reshape(-1).long()], dim=1)
    valid = torch.cat([torch.ones(len(si), dtype=torch.bool, device=dev),
                       ts < n])                     # drop the phantoms
    return from_edges(n, torch.cat([torch.stack([si, sj], dim=1),
                                    new_edges]),
                      valid=valid, max_degree=max_degree, device=dev)


def attachment(n: int, m: int, key: torch.Tensor, *,
               chunk: int | None = None,
               backend: str | None = None) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """``barabasi_albert``'s arrivals on the key's device: (targets
    [arrivals (+ phantoms), m] int32, the endpoint multiset ``ends``).
    ``backend`` goes to ``attach_arrivals`` (the card's parity check
    runs the plain version with it)."""
    dev = key.device
    seed_sz = m + 1
    si, sj = torch.triu_indices(seed_sz, seed_sz, 1, device=dev)
    n_seed_ends = seed_sz * m              # both ends of the seed's edges
    n_arrivals = n - seed_sz
    if chunk is None:
        warm, c, n_blocks = n_arrivals, 1, 0
    else:
        c = int(chunk)
        if c < 1:
            raise ValueError("chunk must be >= 1")
        warm = min(n_arrivals, c)
        n_blocks = -(-(n_arrivals - warm) // c)
    # endpoint slots: the padded capacity holds the phantom arrivals' slabs
    count = warm + n_blocks * c
    ends = torch.zeros(n_seed_ends + 2 * m * count, dtype=torch.int32,
                       device=dev)
    ends[:n_seed_ends] = torch.cat([si, sj])
    tgts = attach_arrivals(key, ends, first=seed_sz, count=count,
                           fill=n_seed_ends, m=m, warm=warm, block=c,
                           backend=backend)
    return tgts, ends


def complete(n: int, *, device=None) -> Topology:
    """Complete graph K_n (the seed Axelrod mixing assumption). Inherently
    dense — the table alone is [n, n-1] — so it stays on the
    ``from_adjacency`` diagnostics path and its size guard (checked before
    the [n, n] argument is allocated)."""
    _check_dense(n, "complete()")
    dev = resolve_device(device)
    return from_adjacency(torch.ones((n, n), dtype=torch.bool, device=dev),
                          max_degree=n - 1, device=dev)

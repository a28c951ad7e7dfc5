"""Padded-CSR contact topology — the substrate for localized dynamics.

Port of ``repro/topology/graph.py``. A ``Topology`` is a fixed-width
neighbor table on one device

    neighbors : [n_nodes, max_degree] int32, row v lists v's neighbors in
                ascending id order, padded with -1 past degrees[v]
    degrees   : [n_nodes] int32

so every gather is a rectangular ``neighbors[v]``, and the -1 padding is
the conflict kernel's "unused id slot": a neighbor row drops straight into
a task's read-id footprint.

``block_graph`` aggregates contiguous node blocks into a smaller graph
(SIRS's subset graph) through the sparse ``from_edges``. The dense helpers
(``adjacency``/``from_adjacency``) are for small-n diagnostics and refuse
above ``DENSE_LIMIT`` nodes.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device

PAD = -1  # unused neighbor slot; also "unused id" in the conflict kernel

#: Largest node count for which dense [n, n] helpers are allowed. Above
#: this, adjacency()/from_adjacency() would allocate multi-GiB boolean
#: matrices; the sparse edge-list path (from_edges) has no limit.
DENSE_LIMIT = 1 << 14


def _check_dense(n: int, what: str) -> None:
    if n > DENSE_LIMIT:
        raise ValueError(
            f"{what} would materialize a dense [{n}, {n}] array "
            f"(~{n * n / 2**30:.1f} GiB as bool); refusing above "
            f"n = {DENSE_LIMIT}. Use the padded-CSR form directly "
            "(Topology.neighbors / from_edges) — the dense helpers exist "
            "for small-n diagnostics only.")


@dataclass(frozen=True)
class Topology:
    """Undirected contact graph in padded neighbor-table form."""

    neighbors: torch.Tensor  # [n_nodes, max_degree] int32, -1 padded
    degrees: torch.Tensor    # [n_nodes] int32
    #: k when this is the ring lattice of ``ring`` (v ± 1..k/2 mod n),
    #: else None: a neighbourhood that is a contiguous slice of the ring,
    #: which SIRS's wave kernel reads as a halo. ``to`` keeps it.
    ring_k: int | None = None

    # ---------------------------------------------------------- properties
    @property
    def n_nodes(self) -> int:
        return self.neighbors.shape[0]

    @property
    def max_degree(self) -> int:
        return self.neighbors.shape[1]

    @property
    def device(self) -> torch.device:
        return self.neighbors.device

    @property
    def n_edges(self) -> torch.Tensor:
        """Undirected edge count (0-d int64). A proper edge appears in two
        rows, a self-loop (block graphs have them) in one."""
        own = torch.arange(self.n_nodes, dtype=torch.int32,
                           device=self.device)[:, None]
        loops = (self.neighbors == own).any(dim=1).sum()
        return (self.degrees.sum() + loops) // 2

    # ------------------------------------------------------------- queries
    def neighbor_mask(self) -> torch.Tensor:
        """[n_nodes, max_degree] bool — True where a slot holds a
        neighbor. Table-shaped, so safe at any n (unlike ``adjacency``)."""
        return self.neighbors >= 0

    def edge_list(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(edges [n·max_degree, 2] int32, valid [n·max_degree] bool):
        every (v, neighbor) slot of the table, one direction per slot.
        Feeding this back through ``from_edges`` reproduces the topology."""
        src = torch.arange(self.n_nodes, dtype=torch.int32,
                           device=self.device).repeat_interleave(
                               self.max_degree)
        dst = self.neighbors.reshape(-1)
        return torch.stack([src, dst], dim=1), dst >= 0

    def gather(self, values: torch.Tensor, rows: torch.Tensor,
               fill=0) -> tuple[torch.Tensor, torch.Tensor]:
        """values[neighbors[rows]] with padded slots replaced by ``fill``.

        rows may have any leading shape; returns (gathered, mask) with shape
        rows.shape + (max_degree,) (+ values' trailing dims).
        """
        nbrs = self.neighbors[rows.long()]
        mask = nbrs >= 0
        out = values[torch.where(mask, nbrs, 0).long()]
        bshape = mask.shape + (1,) * (out.dim() - mask.dim())
        # the fill is made on the device (a fill kernel): a host-built
        # scalar would be a blocking copy, a host sync per call
        fill = torch.full((), fill, dtype=out.dtype, device=out.device)
        return torch.where(mask.reshape(bshape), out, fill), mask

    def neighbor_fraction(self, indicator: torch.Tensor,
                          rows: torch.Tensor) -> torch.Tensor:
        """float32 mean of a boolean per-node indicator over each row's
        neighbors (0 where degree is 0) — e.g. the infected fraction."""
        vals, _ = self.gather(indicator.to(torch.float32), rows, fill=0.0)
        deg = self.degrees[rows.long()].clamp(min=1).to(torch.float32)
        return vals.sum(dim=-1) / deg

    def sample_neighbor(self, keys: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
        """Uniform neighbor of each node ``v`` (keys ``[..., 2]`` and v
        ``[...]``, one draw per key); v must have degree >= 1."""
        v = v.long()
        j = prng.randint(keys, (), 0, self.degrees[v].clamp(min=1))
        return self.neighbors[v, j.long()]

    def to(self, device) -> "Topology":
        return Topology(self.neighbors.to(device), self.degrees.to(device),
                        self.ring_k)

    # -------------------------------------------------------- derived graphs
    def block_graph(self, block_size: int) -> "Topology":
        """Aggregate topology over contiguous node blocks of ``block_size``.

        Block b = nodes [b*s, (b+1)*s). Blocks b1, b2 are adjacent iff some
        edge connects them; every block is adjacent to itself (the paper's
        §4.2 aggregate subset graph, generalized from the ring). Built on
        the topology's device through the sparse ``from_edges``.
        """
        n, s = self.n_nodes, int(block_size)
        if n % s:
            raise ValueError("block_size must divide n_nodes")
        m, dev = n // s, self.device
        blk_src = (torch.arange(n, dtype=torch.int32, device=dev) // s
                   ).repeat_interleave(self.max_degree)            # [N*D]
        blk_dst = torch.where(self.neighbors >= 0,
                              self.neighbors // s, PAD).reshape(-1)  # [N*D]
        loops = torch.arange(m, dtype=torch.int32, device=dev)
        edges = torch.cat([torch.stack([blk_src, blk_dst], dim=1),
                           torch.stack([loops, loops], dim=1)])
        return from_edges(m, edges, allow_self_loops=True, device=dev)

    def adjacency(self) -> torch.Tensor:
        """Dense [n, n] bool adjacency — small-n diagnostics only; raises
        above DENSE_LIMIT nodes instead of allocating O(n²)."""
        n = self.n_nodes
        _check_dense(n, "Topology.adjacency()")
        adj = torch.zeros((n, n + 1), dtype=torch.bool, device=self.device)
        rows = torch.arange(n, device=self.device)[:, None].expand(
            n, self.max_degree)
        cols = torch.where(self.neighbors < 0, n, self.neighbors).long()
        adj[rows, cols] = True  # padded slots land in the scratch column
        return adj[:, :n]


def from_adjacency(adj, *, max_degree: int | None = None,
                   allow_self_loops: bool = False, device=None) -> Topology:
    """Build a Topology from a dense boolean adjacency matrix.

    Small-n diagnostics path (raises above DENSE_LIMIT — use
    ``from_edges`` for anything larger). ``max_degree=None`` computes the
    tight bound (one host sync). A row with more than ``max_degree``
    neighbors keeps its ``max_degree`` lowest-id ones, degrees clamped to
    match. Rows pack neighbor-first through a stable argsort, keeping
    ascending neighbor ids.
    """
    dev = resolve_device(device)
    adj = torch.as_tensor(adj, device=dev).to(torch.bool)
    n = adj.shape[0]
    _check_dense(n, "from_adjacency()")
    if not allow_self_loops:
        adj = adj & ~torch.eye(n, dtype=torch.bool, device=dev)
    degrees = adj.sum(dim=1).to(torch.int32)
    if max_degree is None:
        max_degree = max(int(degrees.max()), 1) if n else 1  # host sync
    degrees = degrees.clamp(max=max_degree)
    # stable sort puts True entries first while keeping column order
    order = torch.argsort((~adj).to(torch.uint8), dim=1,
                          stable=True)[:, :max_degree]
    slot = torch.arange(max_degree, dtype=torch.int32, device=dev)[None, :]
    nbrs = torch.where(slot < degrees[:, None], order, PAD).to(torch.int32)
    return Topology(neighbors=nbrs, degrees=degrees)


def from_edges(n: int, edges, *, max_degree: int | None = None,
               symmetrize: bool = True, allow_self_loops: bool = False,
               valid=None, device=None) -> Topology:
    """Build a Topology from an [E, 2] integer edge array — never [n, n].

    Same semantics as the reference (``repro.topology.from_edges``):

      * an edge may appear in any direction and any number of times —
        entries are symmetrized (unless ``symmetrize=False``) and
        duplicates collapse;
      * entries with a negative endpoint, an endpoint >= n, or
        ``valid[e] == False`` are dropped;
      * self loops are dropped unless ``allow_self_loops``;
      * ``max_degree=None`` computes the tight bound (one host sync); rows
        beyond a given bound keep their ``max_degree`` lowest-id neighbors
        with degrees clamped to match;
      * neighbor rows ascend by node id, padded with -1.

    The reference orders entries with a host counting sort on the key
    ``src·(n+1)+dst``; a stable device sort of that key gives the same
    permutation, so the build stays on ``device``.
    """
    dev = resolve_device(device)
    edges = torch.as_tensor(edges, device=dev).to(torch.int64)
    src, dst = edges[:, 0], edges[:, 1]
    ok = (src >= 0) & (dst >= 0) & (src < n) & (dst < n)
    if valid is not None:
        ok = ok & torch.as_tensor(valid, device=dev).to(torch.bool)
    if not allow_self_loops:
        ok = ok & (src != dst)
    if symmetrize:
        src, dst = torch.cat([src, dst]), torch.cat([dst, src])
        ok = torch.cat([ok, ok])
    # sentinel n sinks dropped entries past every real segment in the sort
    skey = torch.where(ok, src, n)
    dkey = torch.where(ok, dst, n)
    order = torch.sort(skey * (n + 1) + dkey, stable=True).indices
    s, d = skey[order], dkey[order]
    dup = torch.zeros_like(ok)
    dup[1:] = (s[1:] == s[:-1]) & (d[1:] == d[:-1])
    keep = (s < n) & ~dup
    deg = torch.zeros(n + 1, dtype=torch.int64, device=dev).scatter_add_(
        0, s, keep.to(torch.int64))[:n]
    if max_degree is None:
        max_degree = max(int(deg.max()), 1) if n else 1  # host sync
    # slot of each kept entry within its row: rank among kept entries
    # minus the number kept in earlier rows (rows are contiguous and
    # ascending in dst after the sort)
    rank = torch.cumsum(keep.to(torch.int64), 0) - 1
    cdeg = torch.cat([deg.new_zeros(1), torch.cumsum(deg, 0)])
    slot = rank - cdeg[torch.clamp(s, max=n)]
    keep = keep & (slot < max_degree)
    nbrs = torch.full((n, max_degree), PAD, dtype=torch.int32, device=dev)
    nbrs[s[keep], slot[keep]] = d[keep].to(torch.int32)
    return Topology(neighbors=nbrs,
                    degrees=deg.clamp(max=max_degree).to(torch.int32))

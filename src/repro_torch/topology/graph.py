"""Padded-CSR contact topology — the substrate for localized dynamics.

Port of ``repro/topology/graph.py``. A ``Topology`` is a fixed-width
neighbor table on one device

    neighbors : [n_nodes, max_degree] int32, row v lists v's neighbors in
                ascending id order, padded with -1 past degrees[v]
    degrees   : [n_nodes] int32

so every gather is a rectangular ``neighbors[v]``, and the -1 padding is
the conflict kernel's "unused id slot": a neighbor row drops straight into
a task's read-id footprint.

``block_graph`` and the dense helpers (``adjacency``/``from_adjacency``)
are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device

PAD = -1  # unused neighbor slot; also "unused id" in the conflict kernel


@dataclass(frozen=True)
class Topology:
    """Undirected contact graph in padded neighbor-table form."""

    neighbors: torch.Tensor  # [n_nodes, max_degree] int32, -1 padded
    degrees: torch.Tensor    # [n_nodes] int32

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

    # ------------------------------------------------------------- queries
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
        return torch.where(mask.reshape(bshape), out,
                           torch.as_tensor(fill, dtype=out.dtype,
                                           device=out.device)), mask

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
        return Topology(self.neighbors.to(device), self.degrees.to(device))


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

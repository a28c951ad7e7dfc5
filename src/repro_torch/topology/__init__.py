"""Contact-topology subsystem: padded-CSR neighbor tables + generators.

  graph.py       — Topology (neighbors [N, max_deg] int32, -1 padded),
                   masked gathers, the sorted ``from_edges`` constructor
  generators.py  — ring-k, 2D lattice (von Neumann / Moore),
                   Watts-Strogatz, ``connect_isolated``

Port of ``repro.topology``; the random families draw the reference's
exact streams, so the same key gives the same table.
"""
from repro_torch.topology.generators import (
    connect_isolated,
    lattice2d,
    ring,
    watts_strogatz,
)
from repro_torch.topology.graph import PAD, Topology, from_edges

__all__ = [
    "Topology",
    "from_edges",
    "PAD",
    "ring",
    "lattice2d",
    "watts_strogatz",
    "connect_isolated",
]

"""Contact-topology subsystem: padded-CSR neighbor tables + generators.

  graph.py       — Topology (neighbors [N, max_deg] int32, -1 padded),
                   masked gathers, ``block_graph``, the sorted
                   ``from_edges`` constructor, the dense diagnostics
                   helpers (``adjacency``/``from_adjacency``)
  generators.py  — ring-k, 2D lattice (von Neumann / Moore),
                   Watts-Strogatz, Erdos-Renyi, Barabasi-Albert (the
                   attachment kernel on the card), complete,
                   ``connect_isolated``

Port of ``repro.topology``; the random families draw the reference's
exact streams, so the same key gives the same table.
"""
from repro_torch.topology.generators import (
    barabasi_albert,
    complete,
    connect_isolated,
    erdos_renyi,
    lattice2d,
    ring,
    watts_strogatz,
)
from repro_torch.topology.graph import (
    DENSE_LIMIT,
    PAD,
    Topology,
    from_adjacency,
    from_edges,
)

__all__ = [
    "Topology",
    "from_edges",
    "from_adjacency",
    "PAD",
    "DENSE_LIMIT",
    "ring",
    "lattice2d",
    "watts_strogatz",
    "erdos_renyi",
    "barabasi_albert",
    "complete",
    "connect_isolated",
]

GENERATORS = {
    "ring": ring,
    "lattice2d": lattice2d,
    "watts_strogatz": watts_strogatz,
    "erdos_renyi": erdos_renyi,
    "barabasi_albert": barabasi_albert,
    "complete": complete,
}

"""Voter model on an arbitrary contact network.

Port of ``repro/mabs/voter.py``. N agents, each holding one of q
opinions. One *task* = one asynchronous update:

  creation  — draw agent v uniformly; draw u uniformly among v's topology
              neighbors (both ids fixed at creation, so the dependence
              footprint is pure id matching).
  execution — v adopts u's opinion:  opinions[v] := opinions[u].

Footprint R = {u}, W = {v}. Only the strict rule is bit-exact against
sequential execution.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.model import MABSModel, scatter_rows
from repro_torch.topology import Topology
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device


@dataclass
class VoterConfig:
    n_opinions: int = 2


class VoterModel(MABSModel):
    name = "voter"

    def __init__(self, topology: Topology,
                 config: VoterConfig | None = None):
        if int(topology.degrees.min()) < 1:
            raise ValueError(
                "voter dynamics need every node to have a neighbor "
                "(isolated nodes would sample the -1 padding slot)")
        self.topology = topology
        self.cfg = config or VoterConfig()

    # ------------------------------------------------------------- state
    def init_state(self, rng: torch.Tensor, *, device=None):
        rng = rng.to(resolve_device(device))
        opinions = prng.randint(rng, (self.topology.n_nodes,), 0,
                                self.cfg.n_opinions)
        return {"opinions": opinions}

    # ---------------------------------------------------------- creation
    def create_tasks(self, base_key: torch.Tensor, start_index, count: int):
        topo = self.topology
        idx = int(start_index) + torch.arange(count, dtype=torch.int64,
                                              device=base_key.device)
        keys = prng.fold_in(base_key, idx)
        kv, ku = prng.split(keys).unbind(-2)
        v = prng.randint(kv, (), 0, topo.n_nodes)
        u = topo.sample_neighbor(ku, v)
        return {"v": v, "u": u.to(torch.int32), "index": idx.to(torch.int32)}

    # -------------------------------------------------------- dependence
    def task_footprint(self, recipes):
        """R = {u} (the copied opinion), W = {v} (the updated agent)."""
        return recipes["u"][..., None], recipes["v"][..., None]

    def task_write_agents(self, recipes):
        """Writes land in row v — the sharded engine's ownership key."""
        return recipes["v"][..., None]

    def task_read_agents(self, recipes):
        """Only row u is read (row v is fully overwritten), so the halo
        each rank gathers per wave is one row per owned task."""
        return recipes["u"][..., None]

    # --------------------------------------------------------- execution
    def execute_wave(self, state, recipes, mask):
        opinions = state["opinions"]
        new_vals = opinions[recipes["u"].long()]  # all reads before the write
        return {"opinions": scatter_rows(opinions, recipes["v"], new_vals,
                                         mask)}

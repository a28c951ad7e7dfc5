"""SIS (susceptible-infected-susceptible) epidemic on a contact network.

Port of ``repro/mabs/sis.py``. N agents with states S=0 / I=1 (int8). One
*task* = one asynchronous per-agent update:

  creation  — draw agent v uniformly; bind the execution key.
  execution — S -> I with prob beta * (infected fraction of v's neighbors),
              I -> S with prob gamma; reads v's and its neighbors' states.

Footprint R = {v} ∪ neighbors(v) (the padded neighbor row verbatim, -1
slots and all), W = {v}.

Float arithmetic follows the reference's float32 exactly: the infected
fraction is a float32 sum of 0/1 values over the degree, ``beta`` is
rounded to float32 before the multiply (jnp's weak-typed scalar), and the
uniforms are drawn from the recipe keys at execution time.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.model import MABSModel, scatter_rows
from repro_torch.obs.profiler import annotate
from repro_torch.topology import Topology
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device

S, I = 0, 1


@dataclass
class SISConfig:
    beta: float = 0.6    # infection pressure per fully-infected neighborhood
    gamma: float = 0.15  # recovery probability
    i0: float = 0.1      # initial infected fraction


class SISModel(MABSModel):
    name = "sis"

    def __init__(self, topology: Topology, config: SISConfig | None = None):
        self.topology = topology
        self.cfg = config or SISConfig()
        # the rates as float32 scalars on the topology's device
        self._beta, self._gamma = (
            torch.tensor(x, dtype=torch.float32, device=topology.device)
            for x in (self.cfg.beta, self.cfg.gamma))

    # ------------------------------------------------------------- state
    def init_state(self, rng: torch.Tensor, *, device=None):
        rng = rng.to(resolve_device(device))
        u = prng.uniform(rng, (self.topology.n_nodes,))
        i0 = torch.tensor(self.cfg.i0, dtype=torch.float32, device=u.device)
        return {"states": torch.where(u < i0, I, S).to(torch.int8)}

    # ---------------------------------------------------------- creation
    def create_tasks(self, base_key: torch.Tensor, start_index, count: int):
        idx = int(start_index) + torch.arange(count, dtype=torch.int64,
                                              device=base_key.device)
        kv, kx = prng.split(prng.fold_in(base_key, idx)).unbind(-2)
        v = prng.randint(kv, (), 0, self.topology.n_nodes)
        return {"v": v, "index": idx.to(torch.int32), "key": kx}

    # -------------------------------------------------------- dependence
    def task_footprint(self, recipes):
        """R = {v} ∪ neighbors(v) (padded row reused verbatim), W = {v}."""
        v = recipes["v"]
        reads = torch.cat([v[..., None], self.topology.neighbors[v.long()]],
                          dim=-1)
        return reads.to(torch.int32), v[..., None]

    def task_write_agents(self, recipes):
        """Writes land in row v — the sharded engine's ownership key."""
        return recipes["v"][..., None]

    def task_read_agents(self, recipes):
        """Halo contract: the footprint reads ARE state rows here —
        {v} ∪ neighbors(v), padded neighbor row included verbatim."""
        reads, _ = self.task_footprint(recipes)
        return reads

    # --------------------------------------------------------- execution
    def _draws(self, recipes):
        return prng.uniform(recipes["key"])                           # [W]

    def _apply(self, state, recipes, u, mask):
        states = state["states"]
        v = recipes["v"]
        inf_frac = self.topology.neighbor_fraction(states == I, v)  # [W]
        cur = states[v.long()]
        nxt = torch.where(
            (cur == S) & (u < self._beta * inf_frac), I,
            torch.where((cur == I) & (u < self._gamma), S, cur),
        ).to(torch.int8)
        return {"states": scatter_rows(states, v, nxt, mask)}

    def execute_wave(self, state, recipes, mask):
        with annotate("protocol.draws"):
            draws = self._draws(recipes)
        return self._apply(state, recipes, draws, mask)

"""Axelrod-type cultural dynamics (paper §4.1, spec of Băbeanu et al. 2018).

Port of ``repro/mabs/axelrod.py``. N agents, each holding F traits with
values in {0..q-1}, on a contact network: complete-graph mixing by
default, or any ``Topology`` (the target is then a uniform neighbor of
the source). One *task* = one pairwise interaction:

  creation  — draw source uniformly, target uniformly among the source's
              partners; bind the task's execution key.
  execution — overlap o = (1/F) Σ_f [s_f == t_f]; with probability o,
              if 0 < o < 1 and o >= 1 - ω (bounded confidence), the target
              copies one uniformly-chosen differing feature from the source.

Footprint R = {src, tgt}, W = {tgt}: the derived rule equals the
hand-written ``conflicts`` (paper rule src_i == tgt_j or tgt_i == tgt_j,
plus the anti-dependence tgt_i == src_j under the strict closure). Only
the strict rule is bit-exact against sequential execution.

A wave gathers the source and target trait rows, computes the
interaction through ``kernels/axelrod`` (the hand-written kernel on the
card, its plain version on the CPU) and scatters the new target rows.
Float arithmetic follows the reference's float32 exactly: the overlap is
a float32 sum over F divided by F (``jnp.mean``), ``1 - ω`` is formed in
Python doubles and rounded to float32 (jnp's weak-typed scalar), and the
feature pick is the first maximum of the differing features' uniforms.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.model import MABSModel, scatter_rows
from repro_torch.core.workersim import DESModel
from repro_torch.kernels.axelrod import axelrod_wave
from repro_torch.obs.profiler import annotate
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device


@dataclass
class AxelrodConfig:
    n_agents: int = 10_000
    n_features: int = 3     # F — the paper's task-size proxy s
    q: int = 3              # traits per feature
    omega: float = 0.95     # bounded-confidence threshold


class AxelrodModel(MABSModel):
    name = "axelrod"

    def __init__(self, config: AxelrodConfig | None = None, *,
                 topology=None, device=None):
        """topology: optional ``Topology`` restricting partner sampling to
        network neighbors (None = complete-graph mixing). Every node needs
        degree >= 1. The model lives on the topology's device, or on
        ``device`` (default: the card) under complete mixing."""
        self.cfg = config or AxelrodConfig()
        self.topology = topology
        if topology is not None:
            if topology.n_nodes != self.cfg.n_agents:
                raise ValueError("topology size must match n_agents")
            if int(topology.degrees.min()) < 1:
                raise ValueError(
                    "partner sampling needs every node to have a neighbor "
                    "(isolated nodes would sample the -1 padding slot)")
            dev = topology.device
            if device is not None and resolve_device(device) != dev:
                raise ValueError(f"the topology is on {dev}, not {device}")
        else:
            dev = resolve_device(device)
        self.device = dev

    # ------------------------------------------------------------- state
    def init_state(self, rng: torch.Tensor, *, device=None):
        cfg = self.cfg
        rng = rng.to(resolve_device(device))
        return {"traits": prng.randint(rng, (cfg.n_agents, cfg.n_features),
                                       0, cfg.q)}

    # ---------------------------------------------------------- creation
    def create_tasks(self, base_key: torch.Tensor, start_index, count: int):
        n = self.cfg.n_agents
        idx = int(start_index) + torch.arange(count, dtype=torch.int64,
                                              device=base_key.device)
        ks, kt, kx = prng.split(prng.fold_in(base_key, idx), 3).unbind(-2)
        src = prng.randint(ks, (), 0, n)
        if self.topology is None:
            # distinct target: draw from n-1 and shift past src
            tgt = prng.randint(kt, (), 0, n - 1)
            tgt = torch.where(tgt >= src, tgt + 1, tgt)
        else:
            tgt = self.topology.sample_neighbor(kt, src).to(torch.int32)
        # kx is the execution key: randomness is bound at creation
        return {"src": src, "tgt": tgt, "index": idx.to(torch.int32),
                "key": kx}

    # -------------------------------------------------------- dependence
    def task_footprint(self, recipes):
        """R = {src, tgt} (both trait rows are read), W = {tgt}."""
        reads = torch.stack([recipes["src"], recipes["tgt"]], dim=-1)
        return reads, recipes["tgt"][..., None]

    def task_write_agents(self, recipes):
        """The interaction writes (at most) one feature of the target's
        trait row — the sharded engine's ownership key is tgt."""
        return recipes["tgt"][..., None]

    def task_read_agents(self, recipes):
        """Halo contract: both trait rows are read. tgt must be listed
        even though it is the write row — the interaction overwrites a
        single feature, so the rest of tgt's row carries through from its
        pre-wave value."""
        return torch.stack([recipes["src"], recipes["tgt"]], dim=-1)

    def conflicts(self, a, b, *, strict: bool = True):
        """later a vs earlier b — hand-written form of the footprint rule."""
        c = (a["src"] == b["tgt"]) | (a["tgt"] == b["tgt"])  # paper rule
        if strict:
            c = c | (a["tgt"] == b["src"])  # anti-dependence closure
        return c

    # --------------------------------------------------------- execution
    def _draws(self, recipes):
        """The execution draws bound to each task's key: u [W] and the
        feature-pick uniforms [W, F]."""
        ku, kf = prng.split(recipes["key"]).unbind(-2)
        return prng.uniform(ku), prng.uniform(kf, (self.cfg.n_features,))

    def _apply(self, state, recipes, draws, mask):
        traits = state["traits"]
        src, tgt = recipes["src"].long(), recipes["tgt"].long()
        u, gumb = draws
        with annotate("protocol.wave_kernel"):
            new_t, interact = axelrod_wave(traits[src], traits[tgt], u,
                                           gumb, mask, omega=self.cfg.omega)
        # whole target rows where interact, the rest to the scratch row
        # (no host sync). This equals the reference's one-feature scatter:
        # the interacting tasks of one wave have distinct targets
        # (tgt_i == tgt_j conflicts under both rules), so no row is
        # written twice, and a row's other features are its pre-wave
        # values, which no other task of the wave writes.
        return {"traits": scatter_rows(traits, tgt, new_t, interact)}

    def execute_wave(self, state, recipes, mask):
        with annotate("protocol.draws"):
            draws = self._draws(recipes)
        return self._apply(state, recipes, draws, mask)

    # ------------------------------------------------- DES model adapter
    def des_model(self, *, seed: int = 0, exec_cost=None, create_cost=None,
                  strict: bool = True) -> DESModel:
        """Host-side adapter for the protocol simulator (the reference's,
        draw for draw). Recipes are generated with NumPy, identically
        distributed to create_tasks; the neighbour table and degrees are
        copied to the host once, here."""
        cfg = self.cfg
        rs = np.random.RandomState(seed)
        topo_nbrs = topo_deg = None
        if self.topology is not None:
            topo_nbrs = self.topology.neighbors.cpu().numpy()
            topo_deg = self.topology.degrees.cpu().numpy()

        cache: dict[int, tuple[int, int]] = {}

        def recipes_fn(i: int):
            if i not in cache:
                src = int(rs.randint(cfg.n_agents))
                if topo_nbrs is None:
                    tgt = int(rs.randint(cfg.n_agents - 1))
                    if tgt >= src:
                        tgt += 1
                else:
                    tgt = int(topo_nbrs[src, rs.randint(topo_deg[src])])
                cache[i] = (src, tgt)
            return cache[i]

        # record: (targets_seen, sources_seen) as Python sets
        def record_new():
            return (set(), set())

        def record_add(rec, recipe):
            tgts, srcs = rec
            tgts.add(recipe[1])
            srcs.add(recipe[0])
            return rec

        def depends(rec, recipe):
            tgts, srcs = rec
            src, tgt = recipe
            d = (src in tgts) or (tgt in tgts)
            if strict:
                d = d or (tgt in srcs)
            return d

        c_exec = exec_cost if exec_cost is not None else (
            lambda r: 1e-7 * cfg.n_features + 5e-7)
        c_create = create_cost if create_cost is not None else (lambda: 3e-7)
        return DESModel(
            recipes_fn=recipes_fn,
            exec_cost_fn=c_exec,
            create_cost_fn=c_create,
            record_new=record_new,
            record_add=record_add,
            depends=depends,
        )

"""SIRS epidemic on a contact network (paper §4.2, generalized).

Port of ``repro/mabs/sir.py``. N agents on a ``Topology`` (default: the
paper's ring of degree k). States S=0, I=1, R=2 (int8). Per global step
each agent may advance one state — S->I with prob p_SI · (infected
fraction of its neighbours), I->R with prob p_IR, R->S with prob p_RS —
from the *previous* step's states, through a new-state buffer.

Protocol mapping: M = N/s contiguous subsets of size s. Each step emits
2M tasks in chain order [A_0..A_{M-1}, B_0..B_{M-1}]:
  type A (compute): new_states[subset] := transition(states[nbhd(subset)])
  type B (commit):  states[subset]     := new_states[subset]

Footprint — block-granular ids over two disjoint id spaces, states-block
b -> b and new-states-block b -> M + b, with adjacency on the aggregate
subset graph (``Topology.block_graph``, every block adjacent to itself):
  A_i:  R = {blocks adjacent to i},  W = {M + i}
  B_i:  R = {M + i},                 W = {i}
whose derived rules equal the hand-written ``conflicts``.

On the paper's ring (a ``Topology`` built by ``ring``) the A tasks'
transition goes through ``kernels/sir`` (the hand-written kernel on the
card, its plain version on the CPU), which reads each subset's
neighbourhood as a contiguous halo; on any other topology it goes through
the neighbour table (``_transition``, the reference's generalized model).
``reference_step`` always takes ``_transition``. Float arithmetic follows
the reference's float32 exactly on both routes: the infected fraction is
a float32 mean over the degree (a sum of 0/1, exact, divided by k), the
rates are rounded to float32 before use (jnp's weak-typed scalars), and
the uniforms come from the recipe keys, s per task.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.model import MABSModel, scatter_rows
from repro_torch.core.workersim import DESModel
from repro_torch.kernels.sir import sir_wave
from repro_torch.obs.profiler import annotate
from repro_torch.topology import Topology, ring
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device

S, I, R = 0, 1, 2


@dataclass
class SIRConfig:
    n_agents: int = 4_000
    k: int = 14                 # default ring degree (k/2 on each side)
    subset_size: int = 50       # s — chain granularity / task-size proxy
    p_si: float = 0.8
    p_ir: float = 0.1
    p_rs: float = 0.3
    i0: float = 0.05            # initial infected fraction

    @property
    def n_subsets(self) -> int:
        if self.n_agents % self.subset_size:
            raise ValueError("subset_size must divide n_agents")
        return self.n_agents // self.subset_size

    @property
    def block_reach(self) -> int:
        """Ring aggregate-graph adjacency radius in blocks (incl. self=0);
        only meaningful for the default ring topology."""
        return -(-(self.k // 2) // self.subset_size)  # ceil division

    def tasks_per_step(self) -> int:
        return 2 * self.n_subsets


class SIRModel(MABSModel):
    name = "sir"

    def __init__(self, config: SIRConfig | None = None, *,
                 topology: Topology | None = None, device=None):
        """topology: contact network (None = ring of degree cfg.k on
        ``device``, default the card). Block adjacency is derived from
        it."""
        self.cfg = cfg = config or SIRConfig()
        self.topology = topology if topology is not None else ring(
            cfg.n_agents, cfg.k, device=resolve_device(device))
        if self.topology.n_nodes != cfg.n_agents:
            raise ValueError("topology size must match n_agents")
        # the aggregate subset graph, self loops included: its padded
        # rows are the A tasks' read-id footprints
        self.block_topo = self.topology.block_graph(cfg.subset_size)
        self._p_si, self._p_ir, self._p_rs = (
            torch.tensor(x, dtype=torch.float32, device=self.topology.device)
            for x in (cfg.p_si, cfg.p_ir, cfg.p_rs))
        # the paper's ring takes the wave kernel, which reads each
        # subset's neighbourhood as one contiguous halo of s + k states
        k = self.topology.ring_k
        self._ring_k = (k if k is not None and cfg.subset_size + k
                        <= cfg.n_agents else None)

    # ------------------------------------------------------------- state
    def init_state(self, rng: torch.Tensor, *, device=None):
        rng = rng.to(resolve_device(device))
        u = prng.uniform(rng, (self.cfg.n_agents,))
        i0 = torch.tensor(self.cfg.i0, dtype=torch.float32, device=u.device)
        states = torch.where(u < i0, I, S).to(torch.int8)
        return {"states": states, "new_states": states.clone()}

    # ---------------------------------------------------------- creation
    def create_tasks(self, base_key: torch.Tensor, start_index, count: int):
        m = self.cfg.n_subsets
        idx = int(start_index) + torch.arange(count, dtype=torch.int64,
                                              device=base_key.device)
        within = idx % (2 * m)
        return {
            "subset": (within % m).to(torch.int32),
            "type": (within >= m).to(torch.int32),   # 0 = A, 1 = B
            "step": (idx // (2 * m)).to(torch.int32),
            "index": idx.to(torch.int32),
            "key": prng.fold_in(base_key, idx),
        }

    # -------------------------------------------------------- dependence
    def _adjacent(self, b1, b2):
        """b2 ∈ neighbors(b1) on the aggregate graph (broadcasts)."""
        nbrs = self.block_topo.neighbors[b1.long()]          # [..., Db]
        return ((nbrs == b2[..., None]) & (nbrs >= 0)).any(dim=-1)

    def task_footprint(self, recipes):
        """States-block b -> id b, new-states-block b -> id M + b."""
        m = self.cfg.n_subsets
        subset, ttype = recipes["subset"], recipes["type"]
        nbr_blocks = self.block_topo.neighbors[subset.long()]  # [..., Db]
        buf_row = torch.full_like(nbr_blocks, -1)
        buf_row[..., 0] = m + subset
        reads = torch.where((ttype == 1)[..., None], buf_row, nbr_blocks)
        writes = torch.where(ttype == 1, subset, m + subset)[..., None]
        return reads.to(torch.int32), writes.to(torch.int32)

    def _block_rows(self, blocks):
        """Block ids [..., Db] (-1 padded) expanded to their state rows
        [..., Db·s], -1 padded."""
        s = self.cfg.subset_size
        rows = blocks[..., None] * s + torch.arange(
            s, dtype=torch.int32, device=blocks.device)
        rows = torch.where(blocks[..., None] >= 0, rows, -1)
        return rows.reshape(*blocks.shape[:-1], -1).to(torch.int32)

    def task_write_agents(self, recipes):
        """Agent rows written, for the sharded engine's ownership test.

        Unlike ``task_footprint`` (block ids over two abstract id spaces),
        these are actual state-row indices: task (subset, type) writes the
        contiguous rows [subset*s, (subset+1)*s) — of ``new_states`` for a
        compute, of ``states`` for a commit; both leaves shard identically
        so the buffer distinction doesn't matter for ownership."""
        return self._block_rows(recipes["subset"][..., None])

    def task_read_agents(self, recipes):
        """Halo contract (actual state rows, buffer-agnostic — both
        leaves shard identically): a compute reads ``states`` over every
        adjacent block (its agents' contact neighborhoods live there, the
        self loop covers its own block); a commit reads ``new_states``
        over its own block only. Rows: block ids expanded by the subset
        size, [W, Db·s], -1 padded."""
        subset, ttype = recipes["subset"], recipes["type"]
        nbr_blocks = self.block_topo.neighbors[subset.long()]  # [..., Db]
        own = torch.full_like(nbr_blocks, -1)
        own[..., 0] = subset
        blocks = torch.where((ttype == 1)[..., None], own, nbr_blocks)
        return self._block_rows(blocks)

    def conflicts(self, a, b, *, strict: bool = True):
        """later a vs earlier b — hand-written form of the footprint rule."""
        same = a["subset"] == b["subset"]
        adj = self._adjacent(a["subset"], b["subset"])
        a_is_b = a["type"] == 1
        b_is_a = b["type"] == 0
        # paper rules
        c = (a_is_b & b_is_a & same) | (~a_is_b & ~b_is_a & adj)
        if strict:
            # anti: a commit may not overtake a pending compute of an
            # adjacent subset; output: two computes (new_states) or two
            # commits (states) on the same subset
            c = c | (a_is_b & b_is_a & adj)
            c = c | (~a_is_b & b_is_a & same)
            c = c | (a_is_b & ~b_is_a & same)
        return c

    # --------------------------------------------------------- execution
    def _transition(self, states, agents, u):
        """Synchronous SIRS transition for agent rows [..., s] given their
        uniforms [..., s]; reads only ``states``."""
        inf_frac = self.topology.neighbor_fraction(states == I, agents)
        cur = states[agents.long()]
        return torch.where(
            (cur == S) & (u < self._p_si * inf_frac), I,
            torch.where(
                (cur == I) & (u < self._p_ir), R,
                torch.where((cur == R) & (u < self._p_rs), S, cur),
            ),
        ).to(torch.int8)

    def _draws(self, recipes):
        return prng.uniform(recipes["key"], (self.cfg.subset_size,))

    def _apply(self, state, recipes, u, mask):
        cfg = self.cfg
        s_sz = cfg.subset_size
        states, new_states = state["states"], state["new_states"]
        subset, ttype = recipes["subset"], recipes["type"]
        agents = (subset[:, None] * s_sz
                  + torch.arange(s_sz, dtype=torch.int32,
                                 device=subset.device)[None, :])  # [W, s]
        # type A: compute new states from current states — on the ring
        # through the wave kernel (every row, whatever the mask: reading
        # the mask on the host would be a sync), elsewhere through the
        # neighbour table
        if self._ring_k is None:
            nxt = self._transition(states, agents, u)
        else:
            with annotate("protocol.wave_kernel"):
                nxt = sir_wave(states, subset, u, n_agents=cfg.n_agents,
                               k=self._ring_k, subset_size=s_sz,
                               p_si=cfg.p_si, p_ir=cfg.p_ir, p_rs=cfg.p_rs)
        new_states = scatter_rows(new_states, agents, nxt,
                                  (mask & (ttype == 0))[:, None])
        # type B: commit new states
        states = scatter_rows(states, agents, new_states[agents.long()],
                              (mask & (ttype == 1))[:, None])
        return {"states": states, "new_states": new_states}

    def execute_wave(self, state, recipes, mask):
        with annotate("protocol.draws"):
            draws = self._draws(recipes)
        return self._apply(state, recipes, draws, mask)

    # -------------------------------------------------- reference stepper
    def reference_step(self, state, base_key: torch.Tensor, step: int):
        """Whole-system synchronous step (no protocol), with the keys the
        protocol's A tasks of global step ``step`` draw — bit-exact
        against running that step's 2M tasks through any engine."""
        cfg = self.cfg
        m = cfg.n_subsets
        idx = step * 2 * m + torch.arange(m, dtype=torch.int64,
                                          device=base_key.device)
        u = prng.uniform(prng.fold_in(base_key, idx), (cfg.subset_size,))
        agents = torch.arange(cfg.n_agents, dtype=torch.int32,
                              device=base_key.device).reshape(
                                  m, cfg.subset_size)
        nxt = self._transition(state["states"], agents, u).reshape(-1)
        return {"states": nxt, "new_states": nxt.clone()}

    # ------------------------------------------------- DES model adapter
    def des_model(self, *, exec_cost=None, create_cost=None,
                  strict: bool = True) -> DESModel:
        """Host-side adapter for the protocol simulator (the reference's).
        The block graph's neighbours are copied to the host once, here."""
        cfg = self.cfg
        m = cfg.n_subsets
        block_nbrs = self.block_topo.neighbors.cpu().numpy()

        def recipes_fn(i: int):
            step, within = divmod(i, 2 * m)
            ttype, subset = (1, within - m) if within >= m else (0, within)
            return (subset, ttype)

        def record_new():
            return (set(), set())   # (computes_seen, commits_seen) subsets

        def record_add(rec, recipe):
            computes, commits = rec
            subset, ttype = recipe
            (commits if ttype else computes).add(subset)
            return rec

        def adjacent(b, seen: set) -> bool:
            row = block_nbrs[b]
            return any(int(b2) in seen for b2 in row[row >= 0])

        def depends(rec, recipe):
            computes, commits = rec
            subset, ttype = recipe
            if ttype == 1:  # commit
                d = subset in commits if strict else False
                if strict:
                    return d or adjacent(subset, computes)
                return subset in computes
            # compute
            d = adjacent(subset, commits)
            if strict:
                d = d or (subset in computes)
            return d

        c_exec = exec_cost if exec_cost is not None else (
            lambda r: (2e-8 * cfg.k if r[1] == 0 else 4e-9)
            * cfg.subset_size + 5e-7)
        c_create = create_cost if create_cost is not None else (lambda: 3e-7)
        return DESModel(
            recipes_fn=recipes_fn,
            exec_cost_fn=c_exec,
            create_cost_fn=c_create,
            record_new=record_new,
            record_add=record_add,
            depends=depends,
        )

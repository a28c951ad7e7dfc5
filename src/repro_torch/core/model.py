"""Model interface for the adaptive-parallelization protocol.

Port of ``repro/core/model.py``. The paper's two model-side concepts:

  * ``recipe``  — what a task holds after its *creation* part: a dict of
                  tensors with a leading window dimension W.
  * ``record``  — the worker-side dependence test: a pairwise
                  ``conflicts`` predicate from which the prefix-conflict
                  matrix is built (core/records.py).

``create_tasks`` performs the creation part (drawing all randomness, bound
to the task's global chain index — utils/prng.py) and ``execute_wave`` the
execution part for a whole *wave* of commuting tasks at once.

Conflict rules: ``strict=True`` (default) is the full dependence closure
(flow + anti + output hazards) and is bit-exact against sequential
execution; ``strict=False`` is the paper's record rule (flow hazards only).

Footprint protocol: a model may declare per-task id footprints
``task_footprint(recipes) -> (read_ids [W, nr], write_ids [W, nw])``
(int32, -1 = unused slot). ``conflicts`` is then derived from footprint
intersection, and window scheduling goes through the conflict kernel.
"""
from __future__ import annotations

import abc
from typing import Any

import torch

from repro_torch.obs.profiler import annotate

Recipes = Any    # dict of tensors with leading dim W
State = Any      # dict of tensors
Footprint = Any  # (read_ids, write_ids) int32 tensors, -1 padded


def footprint_conflicts(fp_a: Footprint, fp_b: Footprint, *,
                        strict: bool = True) -> torch.Tensor:
    """Pairwise conflict predicate derived from id footprints.

    fp_a/fp_b are (read_ids, write_ids) with broadcastable leading dims and
    trailing id dims; negative ids are unused slots. Later task a conflicts
    with earlier task b iff W_b ∩ R_a (flow; the paper's record rule), plus
    W_b ∩ W_a (output) and W_a ∩ R_b (anti) under the strict closure.
    """
    reads_a, writes_a = fp_a
    reads_b, writes_b = fp_b

    def any_match(x, y):
        eq = x[..., :, None] == y[..., None, :]
        used = (x[..., :, None] >= 0) & (y[..., None, :] >= 0)
        return (eq & used).any(dim=-1).any(dim=-1)

    c = any_match(reads_a, writes_b)
    if strict:
        c = c | any_match(writes_a, writes_b) | any_match(writes_a, reads_b)
    return c


def scatter_rows(values: torch.Tensor, rows: torch.Tensor,
                 new: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """A copy of ``values`` with ``values[rows[i]] = new[i]`` where
    ``mask[i]`` — the reference's ``.at[where(mask, rows, n)].set(...,
    mode="drop")``. Inactive tasks write to a scratch row past the end
    that is then cut off, so the update needs no host sync."""
    with annotate("protocol.scatter_rows"):
        n = values.shape[0]
        ext = torch.cat([values, values.new_zeros((1,) + values.shape[1:])])
        ext.index_put_((torch.where(mask, rows.long(), n),), new)
        return ext[:n]


class MABSModel(abc.ABC):
    """A multi-agent simulation expressible as a chain of localized tasks."""

    #: name used in benchmarks / registries
    name: str = "mabs"

    @abc.abstractmethod
    def init_state(self, rng: torch.Tensor, *, device=None) -> State:
        """Initial simulation state on ``device`` (default: the card)."""

    @abc.abstractmethod
    def create_tasks(self, base_key: torch.Tensor, start_index: int,
                     count: int) -> Recipes:
        """Creation part for tasks [start_index, start_index+count).

        Must be a pure function of (base_key, global task index) so that
        scheduling cannot influence the realized randomness.
        """

    def task_footprint(self, recipes: Recipes) -> Footprint | None:
        """Optional id footprints: (read_ids [W, nr], write_ids [W, nw]),
        int32 with -1 marking unused slots. Returning footprints gives the
        model the derived ``conflicts`` below and puts window scheduling
        on the conflict-kernel path."""
        return None

    def task_write_agents(self, recipes: Recipes) -> torch.Tensor | None:
        """Optional [W, nt] int32 *state-row* indices each task writes
        (-1 = unused slot). This is the sharded engine's ownership
        contract: a task executes on every rank whose agent-row block
        contains at least one of its write targets. Distinct from
        ``task_footprint``, whose ids may live in abstract spaces (e.g.
        SIRS block ids over two buffers); return None (the default) when
        write targets are not state rows — the sharded engine then runs
        every task on every rank (redundant compute, identical result).
        """
        return None

    def task_read_agents(self, recipes: Recipes) -> torch.Tensor | None:
        """Optional [W, nr] int32 *state-row* indices each task reads
        (-1 = unused slot) — the read-side companion of
        ``task_write_agents`` and the sharded engine's halo-exchange
        contract: with both hooks declared, each wave gathers only the
        window's read ∪ write rows (O(max_degree · window) values)
        instead of all-gathering the full O(N) agent state.

        The contract: the rows returned must cover every state row whose
        *pre-wave* value can influence the task's writes, across all
        state leaves — including rows the task only partially overwrites
        (e.g. Axelrod writes one feature of the target's trait row, so
        ``tgt`` must be listed). Like ``task_write_agents`` — and unlike
        ``task_footprint`` — these are actual state-row indices, shared
        by every leaf. Return None (the default) to keep the sharded
        engine on its replicated all-gather fallback.
        """
        return None

    def conflicts(self, a: Recipes, b: Recipes, *,
                  strict: bool = True) -> torch.Tensor:
        """Pairwise predicate: does later task ``a`` conflict with earlier
        task ``b``? Broadcasts like the recipes' leading dims. Default:
        derived from ``task_footprint`` intersection."""
        fa, fb = self.task_footprint(a), self.task_footprint(b)
        if fa is None or fb is None:
            raise NotImplementedError(
                f"{type(self).__name__} must implement task_footprint() "
                "or override conflicts()")
        return footprint_conflicts(fa, fb, strict=strict)

    @abc.abstractmethod
    def execute_wave(self, state: State, recipes: Recipes,
                     mask: torch.Tensor) -> State:
        """Execution part for all tasks where mask[i]; must be correct for
        any conflict-free subset (the scheduler guarantees the mask is one).
        """

    def execute_sequential(self, state: State, recipes: Recipes,
                           count: int) -> State:
        """Oracle: execute tasks one by one in chain order, as
        ``execute_wave`` with one-hot masks. Draws bound to the tasks'
        keys (``_draws``) are made once for the window, not once per
        task: they are a pure function of the keys."""
        first = next(iter(recipes.values()))
        slots = torch.arange(first.shape[0], device=first.device)
        draws = self._draws(recipes)
        for i in range(count):
            state = self._apply(state, recipes, draws, slots == i)
        return state

    def _draws(self, recipes: Recipes) -> Any:
        """The execution-time randomness of a window of tasks, drawn from
        the keys in their recipes (None: the model draws nothing when it
        executes). A model that draws splits ``execute_wave`` into
        ``_apply(state, recipes, self._draws(recipes), mask)``."""
        return None

    def _apply(self, state: State, recipes: Recipes, draws: Any,
               mask: torch.Tensor) -> State:
        """``execute_wave`` with the window's draws given."""
        return self.execute_wave(state, recipes, mask)

    # ---- cost model hooks for the discrete-event protocol simulator ----

    def task_cost(self, recipes: Recipes, index: int) -> float:
        """Predicted execution cost (seconds) of one task, for
        core/workersim.py. Default: uniform unit cost."""
        return 1.0

    def creation_cost(self) -> float:
        """Predicted cost of the creation part of one task."""
        return 0.05

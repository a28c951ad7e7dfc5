"""Distribution: the agent axis of the sharded engines and the LM mesh.

``sharding.py`` holds both of the reference's families: the process-group
layout of the sharded wavefront engines with their halo-exchange helpers
(``AgentGroup`` and the gathers), and the LM rules (the reference's
partition specs of parameters, ZeRO-1 moments, batches and serving
states, and their DTensor placements on a ``DeviceMesh`` or a
``LogicalMesh``). Beside it: ``spmd.py`` (the model code on DTensors,
``shard_map``), ``collectives.py`` (the sharded layers' differentiable,
counted collectives), ``context.py`` (the ambient mesh), ``compress.py``
(int8 error-feedback compression across pods) and ``elastic.py`` (resume
on another mesh).
"""
from repro_torch.distributed.sharding import (
    AgentGroup,
    agent_group,
    all_gather_rows,
    batch_pspec,
    halo_gather,
    halo_scatter,
    pair_halo,
    param_pspec,
    params_shardings,
    states_shardings,
    wave_halo_gather,
    wave_halo_split,
    wave_slab_counts,
    window_halo,
    zero1_pspec,
)

__all__ = [
    "param_pspec",
    "params_shardings",
    "batch_pspec",
    "states_shardings",
    "zero1_pspec",
    "AgentGroup",
    "agent_group",
    "all_gather_rows",
    "halo_gather",
    "halo_scatter",
    "pair_halo",
    "wave_halo_gather",
    "wave_halo_split",
    "wave_slab_counts",
    "window_halo",
]

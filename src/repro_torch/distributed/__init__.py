"""Distribution over the agent axis (``sharding.py``): the process-group
layout of the sharded engines and their halo-exchange helpers. The LM
side of the reference's ``distributed/`` (parameter, batch and state
partition specs, ``compress``, ``context``, ``elastic``) is not ported
yet."""
from repro_torch.distributed.sharding import (
    AgentGroup,
    agent_group,
    all_gather_rows,
    halo_gather,
    halo_scatter,
    pair_halo,
    wave_halo_gather,
    wave_halo_split,
    wave_slab_counts,
    window_halo,
)

__all__ = [
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

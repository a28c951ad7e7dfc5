"""SIRS cells: the port's ``SIRModel`` on its default ring, s from the
traffic's ``task_size``."""
from __future__ import annotations

import torch

from bench.reference import sirs as reference
from bench.work import sirs as work

KERNELS = ("conflict", "levels", "sir")
LAUNCH_COUNTERS = {
    "conflict_join_kernel": ("conflict", ("launches", "block_launches")),
    "wave_levels_kernel": ("levels", ("launches",)),
    "sir_wave_kernel": ("sir", ("launches",)),
}


def _m(config: dict, traffic: dict) -> int:
    return config["n_agents"] // traffic["task_size"]


def build(config: dict, traffic: dict, device):
    from repro_torch.mabs import SIRConfig, SIRModel

    return SIRModel(SIRConfig(
        n_agents=config["n_agents"], k=config["k"],
        subset_size=traffic["task_size"], p_si=config["p_si"],
        p_ir=config["p_ir"], p_rs=config["p_rs"], i0=config["i0"]),
        device=device)


def initial_state(config: dict, traffic: dict, seed: int, device) -> dict:
    """Each agent infected with probability i0, else susceptible, from a
    generator on the device; the buffer equals the states."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(config["n_agents"], generator=gen, device=device)
    states = (u < config["i0"]).to(torch.int8)
    return {"states": states, "new_states": states.clone()}


def reference_run(config: dict, traffic: dict, state: dict, call_seeds,
                  dtype=torch.float32):
    states, new_states, ran = reference.run(
        state["states"], state["new_states"], call_seeds,
        traffic["tasks_per_call"], k=config["k"],
        subset_size=traffic["task_size"], p_si=config["p_si"],
        p_ir=config["p_ir"], p_rs=config["p_rs"], dtype=dtype)
    return {"states": states, "new_states": new_states}, ran


def ids_per_task(config: dict, traffic: dict) -> float:
    return work.ids_per_task(_m(config, traffic))


def call_work(config: dict, traffic: dict) -> tuple[float, float]:
    s, k = traffic["task_size"], config["k"]
    computes, commits = work.counts(traffic["tasks_per_call"],
                                    _m(config, traffic))
    cb, co = work.compute_task(s, k)
    mb, mo = work.commit_task(s)
    return computes * cb + commits * mb, computes * co + commits * mo


def wave_kernel_work(config: dict, traffic: dict,
                     launches: int) -> tuple[float, float]:
    computes, _ = work.counts(traffic["tasks_per_call"], _m(config, traffic))
    return work.wave_kernel(computes, traffic["task_size"], config["k"])

"""Axelrod cells: the port's ``AxelrodModel`` under complete mixing, F
from the traffic's ``task_size``."""
from __future__ import annotations

import torch

from bench.reference import axelrod as reference
from bench.work import axelrod as work

#: the port's kernels the cell runs (``csrc/<name>.cu``)
KERNELS = ("conflict", "levels", "axelrod")
#: profiler kernel name -> the port's counters that count its launches
LAUNCH_COUNTERS = {
    "conflict_join_kernel": ("conflict", ("launches", "block_launches")),
    "wave_levels_kernel": ("levels", ("launches",)),
    "axelrod_wave_kernel": ("axelrod", ("launches",)),
}


def build(config: dict, traffic: dict, device):
    from repro_torch.mabs import AxelrodConfig, AxelrodModel

    return AxelrodModel(AxelrodConfig(
        n_agents=config["n_agents"], n_features=traffic["task_size"],
        q=config["q"], omega=config["omega"]), device=device)


def initial_state(config: dict, traffic: dict, seed: int, device) -> dict:
    """Traits uniform in [0, q), from a generator on the device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {"traits": torch.randint(
        0, config["q"], (config["n_agents"], traffic["task_size"]),
        generator=gen, device=device, dtype=torch.int32)}


def reference_run(config: dict, traffic: dict, state: dict, call_seeds,
                  dtype=torch.float32):
    traits, ran = reference.run(state["traits"], call_seeds,
                                traffic["tasks_per_call"],
                                omega=config["omega"], dtype=dtype)
    return {"traits": traits}, ran


def ids_per_task(config: dict, traffic: dict) -> float:
    return work.IDS_PER_TASK


def call_work(config: dict, traffic: dict) -> tuple[float, float]:
    """(bytes, ops) the tasks of one call need."""
    b, o = work.task(traffic["task_size"])
    t = traffic["tasks_per_call"]
    return b * t, o * t


def wave_kernel_work(config: dict, traffic: dict,
                     launches: int) -> tuple[float, float]:
    """(bytes, ops) of one call's wave kernel launches: every task of
    the call is executed by exactly one of them."""
    return work.wave_kernel(traffic["tasks_per_call"], launches,
                            traffic["window"], traffic["task_size"])

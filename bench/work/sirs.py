"""Least work of SIRS tasks on a ring of degree k with subsets of s.

A compute reads the int8 states of its s agents and of their k / 2
neighbours on each side and writes s int8 next states; it draws its key
(a fold-in) and s uniforms. A commit reads s next states and writes s
states and draws nothing.
"""
from __future__ import annotations

from bench.work import device


def ids_per_task(m: int) -> float:
    """Mean id slots of a record: a compute reads its block and the
    blocks either side (one with a single subset, two with two) and
    writes its buffer block; a commit reads one and writes one."""
    return (min(3, m) + 1 + 2) / 2


def compute_task(s: int, k: int) -> tuple[float, float]:
    draws = device.THREEFRY_OPS + s * device.UNIFORM_OPS
    return 2 * s + k, draws + s * (2 * k + 6)


def commit_task(s: int) -> tuple[float, float]:
    return 2 * s, 0.0


def counts(tasks: int, m: int) -> tuple[int, int]:
    """(computes, commits) among the first ``tasks`` of a call's chain."""
    full, rest = divmod(tasks, 2 * m)
    return full * m + min(rest, m), full * m + max(0, rest - m)


def wave_kernel(computes: int, s: int, k: int) -> tuple[float, float]:
    """(bytes, ops) of the ``sir_wave_kernel`` launches that together
    give ``computes`` computes their next states: each one's halo of
    s + k states, s uniforms and its subset id read, s next states
    written; two operations a neighbour and an agent and six more an
    agent."""
    return computes * (6 * s + k + 4), computes * s * (2 * k + 6.0)

"""Least work of Axelrod tasks at F features.

A task reads the source's and the target's trait rows (int32) and
writes the target's row; it draws its source, its target and three
keys at creation (a fold-in, a three-way split, two bounded integers)
and, to execute, a two-way split, its uniform and F pick uniforms.
"""
from __future__ import annotations

from bench.work import device

#: id slots of a task's record: reads {src, tgt}, writes {tgt}
IDS_PER_TASK = 3


def task(f: int) -> tuple[float, float]:
    """(bytes, ops) of one task."""
    draws = (4 * device.THREEFRY_OPS + 2 * device.RANDINT_OPS
             + 2 * device.THREEFRY_OPS + (1 + f) * device.UNIFORM_OPS)
    return 12 * f, draws + 3 * f + 6


def wave_kernel(active: int, launches: int, w: int,
                f: int) -> tuple[float, float]:
    """(bytes, ops) of ``launches`` launches of ``axelrod_wave_kernel``
    over rows of ``w`` that together execute ``active`` tasks: the mask
    byte of every row; for each executed task its source, target and
    pick rows and its uniform read, its new row and its interact flag
    written; a compare, a select and a compare a feature."""
    return launches * w + active * (16 * f + 5), 3.0 * active * f

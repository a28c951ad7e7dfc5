"""Least work of the level sweep (``wave_levels_kernel``): the window's
prefix matrix read as one bit a pair, the validity bytes and, for a
floored sweep, the int32 floors read, and one int32 level a task
written; one max and one add an edge is not counted (it depends on the
conflicts found)."""
from __future__ import annotations


def sweep(w: int, floored: bool = False) -> tuple[float, float]:
    return w * (w - 1) / 16 + w + 4 * w * (1 + floored), float(w)

"""Least work of the record check's join (``conflict_join_kernel``).

The join's function is the conflict predicate of every pair of tasks:
its inputs are each task's id slots (4 bytes an id) and validity byte,
read once; its output is one bit a pair, written once (a later task
against each earlier one of its window for the prefix matrix, every
pair of the two windows for the block). One operation an id (its insert
or probe in a hash table).
"""
from __future__ import annotations


def prefix(w: int, ids: float) -> tuple[float, float]:
    """(bytes, ops) of one window's prefix matrix: ``w`` tasks of
    ``ids`` id slots each (a mean where tasks differ)."""
    return w * (4 * ids + 1) + w * (w - 1) / 16, w * ids


def block(wi: int, wj: int, ids: float) -> tuple[float, float]:
    """(bytes, ops) of the cross-window block of ``wi`` later tasks
    against ``wj`` earlier ones."""
    return (wi + wj) * (4 * ids + 1) + wi * wj / 8, (wi + wj) * ids

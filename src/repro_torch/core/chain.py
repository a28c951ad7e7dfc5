"""The task chain — a bidirectional linked list, as in the paper (§3.3).

Port of ``repro/core/chain.py`` (pure Python). Used by the discrete-event
protocol simulator (core/workersim.py). The wavefront engines use windowed
recipe tensors instead (core/wavefront.py); this structure exists to model
the *protocol itself* faithfully, including cheap interior erasure, the
enter-lock and the erase-lock.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class TaskNode:
    index: int                      # global chain index (creation order)
    recipe: Any                     # model-side creation payload
    prev: Optional["TaskNode"] = field(default=None, repr=False)
    next: Optional["TaskNode"] = field(default=None, repr=False)
    executing_by: Optional[int] = None   # worker id currently executing
    occupant: Optional[int] = None       # worker id stationed here (per-task lock)
    erased: bool = False


class TaskChain:
    """Bidirectional linked list of pending tasks with O(1) erase."""

    def __init__(self) -> None:
        self.head: Optional[TaskNode] = None
        self.tail: Optional[TaskNode] = None
        self.n_pending = 0
        self.n_created = 0

    def append(self, recipe: Any) -> TaskNode:
        node = TaskNode(index=self.n_created, recipe=recipe)
        self.n_created += 1
        self.n_pending += 1
        if self.tail is None:
            self.head = self.tail = node
        else:
            node.prev = self.tail
            self.tail.next = node
            self.tail = node
        return node

    def erase(self, node: TaskNode) -> None:
        assert not node.erased
        node.erased = True
        self.n_pending -= 1
        p, n = node.prev, node.next
        if p is not None:
            p.next = n
        else:
            self.head = n
        if n is not None:
            n.prev = p
        else:
            self.tail = p

    def __len__(self) -> int:
        return self.n_pending

    def __iter__(self):
        node = self.head
        while node is not None:
            nxt = node.next
            yield node
            node = nxt

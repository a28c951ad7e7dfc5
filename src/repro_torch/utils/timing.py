"""Wall-clock and device timing helpers.

Port of ``repro/utils/timing.py``: ``Timer``, ``block_all``,
``TimingResult`` and ``median_time``, fenced with
``torch.cuda.synchronize`` where the reference calls
``block_until_ready``; plus ``cuda_event_ms``, the port's one way of
timing a kernel on the card.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable

import torch


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0


def _tensor_leaves(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensor_leaves(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensor_leaves(v)


def block_all(out):
    """Fence the device work behind *every* tensor leaf of ``out`` (dicts,
    lists and tuples are walked; other leaves pass through): one
    ``torch.cuda.synchronize`` per CUDA device that holds a leaf, nothing
    for CPU tensors, whose ops are done when they return. Returns
    ``out``."""
    devices = {x.device for x in _tensor_leaves(out)
               if x.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return out


class TimingResult(float):
    """The median seconds, behaving as a bare float everywhere — plus
    the full fenced per-repeat sample list (sorted ascending)."""

    __slots__ = ("samples",)

    samples: tuple

    def __new__(cls, median: float, samples):
        self = super().__new__(cls, median)
        self.samples = tuple(float(s) for s in samples)
        return self

    @property
    def min_s(self) -> float:
        return self.samples[0]

    @property
    def rel_spread(self) -> float:
        """(max - min) / median over the repeats — 0.0 for a single
        repeat."""
        med = float(self)
        if not med or len(self.samples) < 2:
            return 0.0
        return (self.samples[-1] - self.samples[0]) / med


def median_time(fn: Callable[[], object], repeats: int = 5,
                warmup: int = 2) -> TimingResult:
    """Median wall time of ``fn()`` in seconds, each call fenced on every
    output leaf (``block_all``), after ``warmup`` fenced untimed calls.
    Returns a ``TimingResult`` carrying the sorted samples."""
    for _ in range(warmup):
        block_all(fn())
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        block_all(fn())
        times.append(time.perf_counter() - t0)
    times.sort()
    return TimingResult(times[len(times) // 2], times)


def cuda_event_ms(fn: Callable[[], object], reps: int = 25) -> float:
    """Median device time of one ``fn()`` in ms, between CUDA events on
    the current stream, after one warm-up call. A sleep kernel keeps the
    card busy while the launches are enqueued, so the events measure the
    kernels and not the host's launch gaps (for a host-bound function,
    such as a plain version that loops on the host, the gaps are its real
    cost and stay in)."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_event_ms times the card; none is visible")
    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(20_000_000)
    events[0].record()
    for i in range(reps):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1])
                             for i in range(reps))

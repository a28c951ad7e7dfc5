"""Device-profile integration for the protocol phases.

Two timing sources complement each other:

  * the host span tracer (obs/trace.py) — wall-clock structure per
    window, wave and boundary, fenced by ``torch.cuda.synchronize``;
  * ``torch.profiler`` — op-accurate host and device timelines, where the
    protocol phases show up by name because the window executors, the
    waves and the record steps open ``protocol.*`` ranges (``annotate``).

``annotate`` is the port of the reference's ``jax.named_scope`` alias,
which labels traced ops at no run-time cost. Its counterpart here must
cost the untraced loops next to nothing, so it opens a
``torch.profiler.record_function`` range only while a profiler is
recording (the range records nothing otherwise, and opening one is a
dispatcher call), and an NVTX range for external tools when the work is
on the card (a push and a pop, no device work). Neither synchronises.
"""
from __future__ import annotations

import os
from contextlib import contextmanager

import torch
from torch.autograd import profiler as _autograd_profiler


@contextmanager
def annotate(name: str, device=None):
    """Label the enclosed protocol phase ``name`` in device profiles:
    a ``record_function`` range while ``torch.profiler`` records, plus an
    NVTX range when ``device`` (a ``torch.device`` or a name) is a CUDA
    device. Issues no sync."""
    rf = (torch.profiler.record_function(name)
          if _autograd_profiler._is_profiler_enabled else None)
    nvtx = device is not None and torch.device(device).type == "cuda"
    if rf is not None:
        rf.__enter__()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
        if rf is not None:
            rf.__exit__(None, None, None)


@contextmanager
def profile_session(logdir: str | None = None):
    """Device-profiler context: a no-op yielding None when ``logdir`` is
    falsy; else a ``torch.profiler.profile`` session over the CPU and,
    where a card is visible, CUDA activities, whose Chrome trace (with the
    ``protocol.*`` ranges labelling the phases) is written to
    ``logdir/trace.json`` when the block exits. Yields the profiler."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))

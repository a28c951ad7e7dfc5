"""Device-profile integration for the protocol phases.

Two timing sources complement each other:

  * the host span tracer (obs/trace.py) — wall-clock structure per
    window, wave and boundary, fenced by ``torch.cuda.synchronize``, and
    unfenced layer spans (tid 3) with each layer's stream time on the
    card;
  * ``torch.profiler`` — op-accurate host and device timelines, where the
    protocol phases show up by name because the engines, the record
    steps, the waves and their parts open ``protocol.*`` ranges
    (``annotate``).

Both stamp with one clock (``obs/trace.py``), so a tracer export and a
profile of one call overlay.

``annotate`` is the port of the reference's ``jax.named_scope`` alias,
which labels traced ops at no run-time cost. It is the one labelling
entry point: it opens a ``torch.profiler.record_function`` range while a
profiler records, and a layer span while a tracer is installed; with
neither it reads two flags and returns a shared no-op context. Neither
branch synchronises. NVTX ranges for external tools come from
``torch.autograd.profiler.emit_nvtx()``: it sets the profiler flag
``annotate`` reads, and turns every ``record_function`` into an NVTX
range.
"""
from __future__ import annotations

import os
from contextlib import contextmanager, nullcontext

import torch
from torch.autograd import profiler as _autograd_profiler

from repro_torch.obs import trace as _trace

_OFF = nullcontext()


class _Range:
    """A ``protocol.*`` range under a profiler, a tracer or both."""

    __slots__ = ("name", "wave", "tracer", "rf", "layer")

    def __init__(self, name: str, wave, tracer):
        self.name = name
        self.wave = wave
        self.tracer = tracer

    def __enter__(self):
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        if self.tracer is not None:
            self.layer = self.tracer.open_layer(self.name, self.wave)
        return self

    def __exit__(self, *exc):
        if self.tracer is not None:
            self.tracer.close_layer(self.layer)
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


def annotate(name: str, wave: int | None = None):
    """Label the enclosed protocol phase ``name``: a ``record_function``
    range while ``torch.profiler`` records, and a layer span of the
    installed tracer (``wave`` marks a wave's own range; ranges inside it
    inherit it). Issues no sync."""
    tracer = _trace._CURRENT
    if tracer is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Range(name, wave, tracer)


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

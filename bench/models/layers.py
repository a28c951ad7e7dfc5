"""The port's layer-span totals, for the per-layer readers of
``bench/metrics/`` (which touch no module of the port themselves).

``repro_torch.obs.trace.layer_totals()`` sums, over every ``tracing()``
block of the process, a count, host ms and device ms for each layer span
name (the ``protocol.*`` ranges), and the windows the blocks covered. In
``bench/run.py`` one process runs one cell, and only the span-traced
calls run under ``tracing()``, so the totals cover exactly that stretch.
A program without layer spans has no ``layer_totals``: the readers then
report nothing."""
from __future__ import annotations


def per_window(span: str, kind: str) -> float | None:
    """``kind`` ("host_ms" or "device_ms") of the layer spans named
    ``span``, summed and divided by the windows the totals cover; None
    without such a span."""
    try:
        from repro_torch.obs.trace import layer_totals
    except ImportError:  # a program without layer spans
        return None
    t = layer_totals()
    s = t["spans"].get(span)
    if not s or not t["windows"]:
        return None
    return s[kind] / t["windows"]

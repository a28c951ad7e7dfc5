"""CPU tests of the per-layer readers of the port's layer spans
(``creation_ms``, ``draws_ms``, ``scatter_ms``): each on synthetic
totals, None without its span, and all of a family's in a traced run of
each cell at small sizes."""
from __future__ import annotations

import pytest

from bench import harness
from bench.tests.test_bench_harness import CELLS, run_small

#: reader -> (layer span it reads, the kind of ms)
LAYER_READERS = {"creation_ms": ("protocol.create_tasks", "host_ms"),
                 "draws_ms": ("protocol.draws", "device_ms"),
                 "scatter_ms": ("protocol.scatter_rows", "device_ms")}


@pytest.mark.parametrize("quantity", list(LAYER_READERS))
def test_layer_reader_on_synthetic_totals(quantity, monkeypatch):
    from repro_torch.obs import trace

    reader = harness._load_path(harness.reader_path(f"{quantity}.sirs"))
    span, kind = LAYER_READERS[quantity]
    totals = {"windows": 4, "spans": {
        span: {"count": 12, "host_ms": 10.0, "device_ms": 30.0},
        "protocol.wave": {"count": 12, "host_ms": 99.0, "device_ms": 99.0}}}
    monkeypatch.setattr(trace, "layer_totals", lambda: totals)
    assert reader.read({}) == totals["spans"][span][kind] / 4
    del totals["spans"][span]                   # no such span recorded
    assert reader.read({}) is None
    monkeypatch.setattr(trace, "layer_totals",
                        lambda: {"windows": 0, "spans": {}})
    assert reader.read({}) is None


@pytest.mark.parametrize("quantity", list(LAYER_READERS))
def test_layer_reader_without_layer_spans(quantity, monkeypatch):
    """A program whose tracer has no ``layer_totals`` (the parent of the
    layer spans): the reader reports nothing and does not raise."""
    from repro_torch.obs import trace

    monkeypatch.delattr(trace, "layer_totals")
    reader = harness._load_path(harness.reader_path(f"{quantity}.axelrod"))
    assert reader.read({}) is None


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_layer_metrics(cell):
    """A traced CPU run of each cell reports its family's creation, draws
    and scatter ms (six metrics over the two families), from the layer
    spans of its own traced calls."""
    from repro_torch.obs import trace

    trace.reset_layer_totals()
    result, _ = run_small(cell, trace=True)
    fam = harness.Cell(cell).config["family"]
    for quantity in LAYER_READERS:
        m = result["metrics"][f"{quantity}.{fam}"]
        assert m["unit"] == "ms" and m["value"] > 0.0
    untraced, _ = run_small(cell, trace=False)
    assert not {f"{q}.{fam}" for q in LAYER_READERS} & set(
        untraced["metrics"])
    totals = trace.layer_totals()
    assert totals["windows"] > 0
    assert (totals["spans"]["protocol.create_tasks"]["count"]
            == totals["windows"])

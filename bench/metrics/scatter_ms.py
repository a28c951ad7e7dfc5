"""Device ms a window in the port's ``protocol.scatter_rows`` layer spans
(each wave's write of its rows into a copy of the state): the traced
calls' totals divided by the windows they covered
(``bench/models/layers.py``)."""
from bench.models.layers import per_window


def read(ctx):
    return per_window("protocol.scatter_rows", "device_ms")

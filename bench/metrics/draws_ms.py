"""Device ms a window in the port's ``protocol.draws`` layer spans (each
``execute_wave``'s draws from its tasks' keys), summed over the window's
waves: the traced calls' totals divided by the windows they covered
(``bench/models/layers.py``)."""
from bench.models.layers import per_window


def read(ctx):
    return per_window("protocol.draws", "device_ms")

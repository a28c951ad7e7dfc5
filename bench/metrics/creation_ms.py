"""Host ms a window inside ``create_tasks``: the port's
``protocol.create_tasks`` layer spans over the traced calls, divided by
the windows they covered (``bench/models/layers.py``). Creation is bound
by the host's dispatch."""
from bench.models.layers import per_window


def read(ctx):
    return per_window("protocol.create_tasks", "host_ms")

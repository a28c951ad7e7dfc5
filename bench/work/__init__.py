"""The least work (bytes, operations) of the kernels and tasks the cells
run, counted from shapes, and the card's peaks. Frozen: the port's own
``ops.py::work`` and ``obs/costs.py`` are not read."""

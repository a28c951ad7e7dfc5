"""The benchmark of ``repro_torch``, the PyTorch/CUDA port.

One command runs one cell once (``python3 bench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``). Everything that belongs to a
configuration, a traffic mix or a metric is found by its name in
``BENCHMARK.json``:

  configs/<config>.json   the configuration's sizes (``family`` names its
                          adapter and its reference)
  traffic/<traffic>.json  the engine path and the task stream of a cell
  models/<family>.py      builds the port's model and the cell's state
  reference/<family>.py   the plain reference the run is judged against
  work/                   the least bytes and operations of each kernel
                          and of a task, and the card's peaks
  metrics/<metric>.py     one reader per metric: ``read(ctx)`` gives the
                          value, or None where it finds nothing to read;
                          a metric ``<quantity>.<suffix>`` without a file
                          of its own is read by ``metrics/<quantity>.py``
"""

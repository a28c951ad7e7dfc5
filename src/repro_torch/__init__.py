"""PyTorch/CUDA port of the adaptive-parallelization protocol.

A second package beside the JAX reference (``repro``), with the same
subpackage names: ``core`` (model interface, records, wave execution,
protocol API), ``engine`` (sequential oracle, the wavefront engine with
and without cross-window overlap), ``mabs`` (voter, SIS, Axelrod, SIRS),
``topology`` (padded-CSR graphs and generators), ``kernels``
(hand-written Hopper kernels with their plain PyTorch versions), ``obs``
(span tracer, stats registry, profiler ranges, provenance), ``utils``
(the ``jax.random``-exact PRNG, device policy, timing), ``bridge``
(numpy hand-over from the reference), and the LM serving path of the
dense family: ``configs`` (the architecture configs), ``models``
(layers, attention with the ring KV cache, the decoder stack, ``Model``),
``serving`` (the protocol-scheduled ``ServingEngine``) and
``launch/serve.py``; and their training path: ``train`` (AdamW, LR
schedules, the train step, the synthetic data stream, checkpoints in the
reference's layout, the resuming loop) and ``launch/train.py``.

The port imports torch and numpy, never JAX and nothing of ``repro``.
Entry points run on the card unless a caller names another device.
"""

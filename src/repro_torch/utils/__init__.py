"""Utilities: the ``jax.random``-exact PRNG (``prng``), the device
policy of the entry points (``device``) and fenced timing
(``timing``)."""

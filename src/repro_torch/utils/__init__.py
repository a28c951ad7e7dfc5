"""Utilities: the ``jax.random``-exact PRNG (``prng``) and the device
policy of the entry points (``device``)."""

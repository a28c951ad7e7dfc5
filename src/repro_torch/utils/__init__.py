"""Utilities: the ``jax.random``-exact PRNG (``prng``), the device
policy of the entry points (``device``), fenced timing (``timing``) and
the reference's leaf paths of the port's trees (``pytree``)."""

"""Adapters from a configuration and a traffic mix to the port's model,
one module per family."""

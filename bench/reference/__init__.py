"""Plain references, one module per model family. They import nothing of
the port and nothing of the JAX package."""

"""Seconds from the process's start to the first measured call: imports,
the CUDA context, the kernel builds of a first run, the state made from
the seed and the warm-up calls."""


def read(ctx):
    return ctx["setup_s"]

"""Tasks the window completed over the window's whole time (whole
``run_engine`` calls, each ending in a synchronize)."""


def read(ctx):
    win = ctx.get("window")
    return None if win is None else win["tasks"] / win["seconds"]

"""The engine's executed (fused) waves over its windows, over the traced
calls: the schedule's shape."""


def read(ctx):
    t = ctx.get("traced")
    return None if not t or not t["windows"] else t["waves"] / t["windows"]

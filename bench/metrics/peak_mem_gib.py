"""``torch.cuda.max_memory_allocated()`` over the window, in GiB, after a
reset when the window starts."""


def read(ctx):
    if ctx.get("window") is None or not ctx["peak_bytes"]:
        return None
    return ctx["peak_bytes"] / 2**30

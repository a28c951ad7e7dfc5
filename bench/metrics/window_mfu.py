"""The least time of the work the profiled call's tasks need (their
state rows read and written once, their Threefry draws, their update
arithmetic; ``bench/work``) over the call's wall time, % of the card's
peaks."""
from bench.work import device


def read(ctx):
    p = ctx.get("profile")
    if p is None:
        return None
    nbytes, ops = ctx["family"].call_work(ctx["config"], ctx["traffic"])
    return 100.0 * device.least_seconds(nbytes, ops) / p["window_s"]

"""The least time of the profiled call's Axelrod waves (every task
executed once; ``bench/work/axelrod.py``) over the device time of its
``axelrod_wave_kernel`` launches, %."""
from bench.work import device


def read(ctx):
    p = ctx.get("profile")
    secs = p and p["kernel_s"].get("axelrod_wave_kernel")
    if not secs:
        return None
    launches = p["counters"]["axelrod.launches"]
    nbytes, ops = ctx["family"].wave_kernel_work(ctx["config"],
                                                 ctx["traffic"], launches)
    return 100.0 * device.least_seconds(nbytes, ops) / secs

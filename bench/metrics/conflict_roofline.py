"""The least time of the profiled call's record-check joins (each
window's prefix matrix and, with overlap, each boundary's block;
``bench/work/conflict.py``) over the device time of every
``conflict_join_kernel`` launch, %."""
from bench.work import conflict, device


def read(ctx):
    p = ctx.get("profile")
    secs = p and p["kernel_s"].get("conflict_join_kernel")
    if not secs:
        return None
    w = ctx["traffic"]["window"]
    ids = ctx["family"].ids_per_task(ctx["config"], ctx["traffic"])
    least = (p["counters"]["conflict.launches"]
             * device.least_seconds(*conflict.prefix(w, ids))
             + p["counters"]["conflict.block_launches"]
             * device.least_seconds(*conflict.block(w, w, ids)))
    return 100.0 * least / secs

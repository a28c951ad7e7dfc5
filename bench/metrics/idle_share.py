"""Share of the profiled call's wall time in which no operation ran on
the device: 1 - (union of the device events' intervals) / wall, %. The
profile is read only when it recorded every launch the port counted."""


def read(ctx):
    p = ctx.get("profile")
    if p is None or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])

"""Mean fenced ``execute`` span a window (its waves, fused or not), ms."""
import statistics


def read(ctx):
    vals = [r["execute"] for r in ctx.get("spans") or [] if "execute" in r]
    return statistics.fmean(vals) if vals else None

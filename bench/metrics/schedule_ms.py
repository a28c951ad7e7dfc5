"""Mean fenced ``schedule`` span a window (creation, record check,
levels), ms."""
import statistics


def read(ctx):
    vals = [r["schedule"] for r in ctx.get("spans") or [] if "schedule" in r]
    return statistics.fmean(vals) if vals else None

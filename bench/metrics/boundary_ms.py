"""Mean fenced ``boundary`` span (cross-window block, carry frontier,
floored levels) over the windows that have one, ms."""
import statistics


def read(ctx):
    vals = [r["boundary"] for r in ctx.get("spans") or [] if "boundary" in r]
    return statistics.fmean(vals) if vals else None

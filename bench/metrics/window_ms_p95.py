"""95th percentile over the traced windows of a window's fenced
schedule + boundary + execute spans (``obs/trace.py``), ms."""
import statistics


def read(ctx):
    rows = ctx.get("spans")
    if not rows or len(rows) < 2:
        return None
    totals = [sum(r.values()) for r in rows]
    return statistics.quantiles(totals, n=20, method="inclusive")[18]

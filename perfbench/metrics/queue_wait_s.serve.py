"""The scheduler's queue wait: the median of the port's
``Request.queue_s`` (due time to prefill start) over the window's
requests."""
import statistics


def read(ctx):
    waits = [r["queue_s"] for r in ctx.records if r["ok"]]
    return statistics.median(waits) if waits else None

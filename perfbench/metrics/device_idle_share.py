"""The share of the profiled part's host time in which no operation ran
on the device (the union of the profiler's device intervals).  The
reader of every ``device_idle_share.<cells>`` metric (``files.reader``)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - tr.busy_s / tr.window_s)

"""B.1 (the strip kernel) against its roofline in the profiled part: the
least time its calls could take on the card (``work/counts.py``,
``work/peaks.py``) over the device time of the kernels named
``strip_*kernel``."""
from perfbench.work import counts, peaks, traced


def read(ctx):
    reqs = traced.requests(ctx)
    spent = ctx.trace.group_s["strip"] if ctx.trace else 0.0
    if not reqs or spent <= 0:
        return None
    least = sum(peaks.least_seconds(*counts.strip_work(ctx.cfg, r["bucket"]))
                for r in reqs)
    return 100.0 * least / spent

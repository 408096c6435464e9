"""B.2 (block-sparse attention) against its roofline in the profiled
part: the least time of the kept blocks' work (``work/counts.py``) over
the device time of the kernels named ``bsa_*kernel``."""
from perfbench.work import counts, peaks, traced


def read(ctx):
    reqs = traced.requests(ctx)
    spent = ctx.trace.group_s["bsa"] if ctx.trace else 0.0
    if not reqs or spent <= 0:
        return None
    least = sum(peaks.least_seconds(*counts.bsa_work(
        ctx.cfg, r["bucket"], r["density"], r["dense_heads"])) for r in reqs)
    return 100.0 * least / spent

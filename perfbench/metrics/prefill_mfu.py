"""The prefill step's share of the card's bf16 peak in the profiled part:
the FLOPs the traced requests' prefills need (``work/counts.py``:
projections and MLP at the prompt's tokens, attention over the kept share
of causal blocks, B.1's strip) over the profiled part's host time."""
from perfbench.work import counts, peaks, traced


def read(ctx):
    reqs = traced.requests(ctx)
    if not reqs or ctx.trace.window_s <= 0:
        return None
    need = sum(counts.prefill_flops(ctx.cfg, r["prompt_len"], r["density"])
               for r in reqs)
    return 100.0 * need / (ctx.trace.window_s * peaks.BF16_FLOPS)

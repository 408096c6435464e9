"""The served model's share of the card's bf16 peak in the profiled part:
the FLOPs the prefills and the decoded tokens completed there need
(``work/counts.py``: experts at the routed top-k tokens, not at capacity
slots) over the profiled part's host time."""
from perfbench.work import counts, peaks, traced


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0:
        return None
    need = sum(counts.prefill_flops(ctx.cfg, r["prompt_len"], r["density"])
               for r in traced.requests(ctx))
    need += sum(counts.decode_flops(ctx.cfg, plen + j)
                for plen, j in traced.decode_tokens(ctx))
    return 100.0 * need / (tr.window_s * peaks.BF16_FLOPS) if need else None

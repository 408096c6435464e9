"""Time to first token of every request of the window: the port's own
span, ``Request.ttft_s`` (from the request's due time to its first token
on the host); a request that failed or never answered counts as missing
(infinite)."""
import math

import numpy as np


def ttfts(ctx):
    return [r["ttft_s"] if r["ok"] else math.inf for r in ctx.records]


def percentile(ctx, q):
    v = ttfts(ctx)
    if not v:
        return None
    p = float(np.percentile(np.asarray(v), q, method="linear"))
    return p if math.isfinite(p) else 1e9

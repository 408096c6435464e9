"""SharePrefill's kept share of causal blocks: each request's
``pattern_stats["block_density"]`` (the port's counter), averaged over the
window's requests weighted by their causal blocks."""


def read(ctx):
    bs = ctx.cfg["port"]["block_size"]
    w = [((r["bucket"] // bs) * (r["bucket"] // bs + 1) / 2, r["density"])
         for r in ctx.records if r["ok"] and r["density"] is not None]
    total = sum(c for c, _ in w)
    return sum(c * d for c, d in w) / total if total else None

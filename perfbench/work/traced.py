"""Which requests' work fell in a traced run's profiled part."""


def requests(ctx):
    """The requests whose first token came inside the profiled part."""
    tr = ctx.trace
    if tr is None:
        return []
    return [r for r in ctx.records + ctx.after
            if r["ok"] and r["t_first"] is not None
            and tr.t0 <= r["t_first"] <= tr.t1]


def decode_tokens(ctx):
    """(prompt length, position) of each decoded token produced inside
    the profiled part; a request's decoded tokens are taken as evenly
    spaced between its first token and its end."""
    tr = ctx.trace
    out = []
    for r in ctx.records + ctx.after:
        n = len(r["tokens"]) - 1
        if not r["ok"] or r["t_first"] is None or n <= 0:
            continue
        for j in range(1, n + 1):
            t = r["t_first"] + r["decode_s"] * j / n
            if tr.t0 <= t <= tr.t1:
                out.append((r["prompt_len"], j))
    return out

"""Prompt tokens of every request completed in the window over the
window's time (host clock); padding is not counted."""


def read(ctx):
    done = [r for r in ctx.records if r["ok"]]
    if not done:
        return None
    return sum(r["prompt_len"] for r in done) / (ctx.t_close - ctx.t_open)

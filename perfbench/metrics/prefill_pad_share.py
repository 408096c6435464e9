"""Bucket padding: the share of the token positions the port's prefills
computed (its counter ``Request.prefill_positions``: each admission's
bucket, or packed segment) that no prompt token fills, over the window's
completed requests.  None where the records do not carry the counter."""


def read(ctx):
    done = [r for r in ctx.records if r["ok"]]
    computed = [r.get("prefill_positions") for r in done]
    if not done or None in computed or sum(computed) <= 0:
        return None
    return 100.0 * (1.0 - sum(r["prompt_len"] for r in done)
                    / sum(computed))

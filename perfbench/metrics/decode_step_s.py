"""The scheduler's decode step on the host clock: the median duration of
the port's ``sched.decode_step`` spans in the profiled part
(``perfbench/spans.py``)."""
import statistics

from perfbench import spans


def read(ctx):
    t = spans.spans_of(ctx)
    steps = t.host_s.get("sched.decode_step") if t is not None else None
    return statistics.median(steps) if steps else None

"""The card's idle share inside the scheduler's decode steps: the device's
idle seconds under the port's ``sched.decode_step`` spans over their host
seconds, in the profiled part (``perfbench/spans.py``)."""
from perfbench import spans


def read(ctx):
    t = spans.spans_of(ctx)
    steps = t.host_s.get("sched.decode_step") if t is not None else None
    if not steps or sum(steps) <= 0:
        return None
    return 100.0 * t.idle_s.get("sched.decode_step", 0.0) / sum(steps)

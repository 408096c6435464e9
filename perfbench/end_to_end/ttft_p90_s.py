"""The 90th percentile of time to first token over all requests of the
window (``perfbench/ttft.py``)."""
from perfbench.ttft import percentile


def read(ctx):
    return percentile(ctx, 90)

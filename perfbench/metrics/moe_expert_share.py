"""The MoE's expert products against the card's kernel time: the device
seconds under the port's ``moe.experts`` spans (every capacity slot's
SwiGLU) over the kernel time of the profiled part (``perfbench/spans.py``)."""
from perfbench import spans


def read(ctx):
    return spans.device_share(ctx, "moe.experts")

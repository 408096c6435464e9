"""The MoE's one-hot dispatch and combine against the card's kernel time:
the device seconds under the port's ``moe.dispatch`` and ``moe.combine``
spans over the kernel time of the profiled part (``perfbench/spans.py``)."""
from perfbench import spans


def read(ctx):
    return spans.device_share(ctx, "moe.dispatch", "moe.combine")

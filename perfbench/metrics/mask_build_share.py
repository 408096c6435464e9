"""SharePrefill's mask staging against the card's kernel time: the
device seconds of the operations launched under the port's
``share.masks`` spans (strips, estimate, lookup, decision,
vertical-slash search, mask select, head permutation) over the kernel
time of the profiled part (``perfbench/spans.py``)."""
from perfbench import spans


def read(ctx):
    return spans.device_share(ctx, "share.masks")

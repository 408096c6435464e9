"""Set-up: from the process's start to the window's (imports, weights
made on the card, the clustering, the warm-up of every bucket the traffic
uses, and in a checkout's first run the kernels' build)."""


def read(ctx):
    return ctx.setup_s

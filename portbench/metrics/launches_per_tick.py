"""Launches of the port's hand-written kernels a tick: the sum of the
``ops/cuda_lib`` launch counters over the window, over its ticks."""


def read(ctx):
    if not ctx.ticks or not ctx.launches:
        return None
    return sum(ctx.launches.values()) / ctx.ticks

"""Device milliseconds a tick of everything that is not one of the port's
hand-written kernels (the ``__global__`` functions of its ``csrc``): the
lanes entry points' operand packing, the masked selects after each update,
the generic route's h in PyTorch, copies and sets."""


def read(ctx):
    if not ctx.ticks or not ctx.device_events[0]:
        return None
    from portbench.trace import port_kernel_names

    glue = ctx.device_s_total() - ctx.device_s_matching(port_kernel_names())
    return 1e3 * glue / ctx.ticks

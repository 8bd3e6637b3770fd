"""Percent of the traced window in which no device activity ran: one less
the union of the device intervals over the window's wall time."""


def read(ctx):
    if not ctx.device_events[0] or ctx.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - ctx.busy_s() / ctx.window_s)

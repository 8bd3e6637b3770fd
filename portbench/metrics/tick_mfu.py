"""The whole tick's share of the card's float32 peak: the operations that
every predict and every update of the window need (``portbench/work``),
over the window's wall time on the host's clock and the peak. It bounds
every stage's roofline share: a stage that left the card idle, or moved
work outside the kernels it is read over, still shows here."""

from portbench.trace import PEAKS


def read(ctx):
    if not ctx.ticks or not ctx.device_events[0]:
        return None
    ops = ctx.stage("predict").work(ctx)[0] + ctx.stage("update").work(ctx)[0]
    return 100.0 * ops / (ctx.window_s * PEAKS["f32_ops_per_s"])

"""Host milliseconds of one ``pose_driver.pose_step_bank_lanes`` call,
averaged over the window's ticks (the harness's host clock around each
call; a call that waits for the card counts its wait)."""


def read(ctx):
    if not ctx.host_ms:
        return None
    return sum(ctx.host_ms) / len(ctx.host_ms)

"""The update stage's share of its roofline: the work of every update the
window ran (``portbench/work/update.py``), over the device time of the
kernels that ``portbench/work/kernels/<kernel>.json`` assign to the stage."""


def read(ctx):
    return ctx.roofline_pct("update")

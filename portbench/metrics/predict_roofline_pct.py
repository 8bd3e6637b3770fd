"""The predict stage's share of its roofline: the larger of its
operations over the float32 peak and its bytes over the HBM peak
(``portbench/work/predict.py``), over the device time of the kernels that
``portbench/work/kernels/<kernel>.json`` assign to the stage."""


def read(ctx):
    return ctx.roofline_pct("predict")

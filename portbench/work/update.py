"""Work of the update stage: every update the window's schedule ran, on
every vehicle, whichever route the program takes it by;
``kernels/<kernel>.json`` say whose device time the stage is read over.

Operations a vehicle's update needs, for a measurement model of dimension
m (float32):

* the factor (``common.factor_ops``, exact);
* counted off the reference (``common.count_ops``) at the cell's start
  state: the 107 sigma points μ ⊞ δ, the model's h on each
  (``portbench/reference/models/<model>.py``) with any operand it works out
  from the state, and the mean's correction μ ⊞ Kν;
* exact: the mean of Z and its deviations (2m a point); S = ½ΣdZdZᵀ + R
  over its valid half, 2 a term; C = ½ΣδdZᵀ, whose 106 moved deltas are ±
  the factor's columns, so each has the factor's valid half of non-zeros:
  2·HALF·m a sign, 2 a term; the gain K = C·S⁻¹ (S's factor m³/3, 2·53·m²
  to solve), the innovation and NIS (m² + m), Kν (2·53·m); the downdate
  P − K·S·Kᵀ over the valid half: K·S (2·53·m²), then 2m a half-entry and
  the subtraction.

Bytes: the covariance's valid half and the mean read and written, z and
R's valid half and the model's per-vehicle operands read, the NIS and the
gate's decision written.
"""

import torch

from portbench.work.common import (HALF, N, POINTS, STORAGE, count_ops, factor_ops, itemsize, representative,
                                   sigma_points)


def per_vehicle(config: dict, mix: dict, name: str) -> tuple:
    from portbench.reference import pose_ukf as ref
    from portbench.reference.models import load

    model = load(name)
    mu, cov, p, rr = representative(config, mix)
    points, x = sigma_points(mu, cov)
    aux_ops, aux = count_ops(model.aux, mu, rr, p) if hasattr(model, "aux") else (0.0, torch.ones(1, dtype=mu.dtype))
    h_ops, z = count_ops(model.h, x, p, aux)
    correction, _ = count_ops(ref.boxplus, mu, torch.zeros(1, N, dtype=mu.dtype))
    m = z.shape[-1]
    ops = (factor_ops() + points + aux_ops + h_ops + POINTS * 2 * m + POINTS * m * (m + 1) + m * m
           + 2 * 2 * HALF * m + (m**3 / 3 + 2 * N * m * m) + m * m + m + 2 * N * m + correction
           + 2 * N * m * m + 2 * HALF * m + HALF)
    elems = 2 * HALF + 2 * STORAGE + m + m * (m + 1) // 2 + model.AUX_OPERANDS + 2
    return ops, elems


def work(ctx) -> tuple:
    """(float32 operations, bytes) of every update the window ran."""
    counts = {}
    ops = nbytes = 0.0
    size = itemsize(ctx.dtype)
    for tick in ctx.schedule:
        for name in tick:
            if name not in counts:
                counts[name] = per_vehicle(ctx.config, ctx.mix, name)
            o, e = counts[name]
            ops += o * ctx.bank
            nbytes += e * size * ctx.bank
    return ops, nbytes

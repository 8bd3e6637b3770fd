"""Work of the prediction stage: every tick, every vehicle.

Operations a vehicle's predict needs (float32):

* the factor of its covariance (``common.factor_ops``, exact);
* counted off the reference (``common.count_ops``) at the cell's start
  state: the 107 sigma points μ ⊞ δ, the process model on each, the
  iterative mean (the flat rows' sum and the quaternion's mean, to a step
  at float32's resolution), the deviations Y ⊟ μ, and the tick's process
  noise (its rotation, the water-current terms, the dt² scaling);
* ½ΣDDᵀ over the valid half (2 operations an entry and a point, exact) and
  the noise added to it.

Bytes a vehicle's predict needs: its covariance's valid half, its mean and
gyro rate read; with per-vehicle parameters (a draw), their decay rates,
rest points, noise half and the 12 scalars of the noise's rotation and
scaling read too; the covariance's valid half and the mean written.
"""

from portbench.work.common import (F32_TOL, HALF, POINTS, STORAGE, count_ops, factor_ops, itemsize,
                                   representative, sigma_points)


def per_vehicle(config: dict, mix: dict) -> tuple:
    from portbench.reference import pose_ukf as ref

    mu, cov, p, rr = representative(config, mix)
    points, x = sigma_points(mu, cov)
    process, y = count_ops(ref.process_model, x, rr, p, mix["dt"])
    mean, mu_y = count_ops(ref.manifold_mean, y, F32_TOL)
    deviations, _ = count_ops(ref.boxminus, y, mu_y[None])
    noise, _ = count_ops(ref.step_noise, mu, p, mix["dt"])
    ops = factor_ops() + points + process + mean + deviations + 2 * POINTS * HALF + noise + HALF
    banked = bool(config.get("draw"))
    elems = HALF + STORAGE + 3 + (2 * STORAGE + HALF + 12 if banked else 0) + HALF + STORAGE
    return ops, elems


def work(ctx) -> tuple:
    """(float32 operations, bytes) of the window's predicts."""
    ops, elems = per_vehicle(ctx.config, ctx.mix)
    n = ctx.ticks * ctx.bank
    return ops * n, elems * itemsize(ctx.dtype) * n

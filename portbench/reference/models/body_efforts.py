"""Model-aided body efforts: the Fossen inverse dynamics with the sigma
point's (x, y, ψ) inertia and dampings, the body velocity relative to the
water, and the compensated body rate (``aux``, worked out from the state)."""

import torch

from portbench.reference.pose_ukf import (ACC, INERTIA, LIN_D, QUAD_D, QUAT, VEL, WV, body_rate, embed,
                                          fossen_efforts, rotate_inv)

AUX_OPERANDS = 3  # the body rate


def aux(mu, rr, p):
    return body_rate(mu, rr, p)


def h(x, p, rr):
    v = p.vehicle  # a per-vehicle (S, 6, 6) inertia broadcasts against (K, S) sigma points
    m = v._replace(inertia=embed(v.inertia, x[..., INERTIA]), lin_damping=embed(v.lin_damping, x[..., LIN_D]),
                   quad_damping=embed(v.quad_damping, x[..., QUAD_D]))
    q = x[..., QUAT]
    pad = torch.zeros_like(x[..., 0:1])
    cross = lambda a, b: torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)
    vb = rotate_inv(q, x[..., VEL]) - cross(rr, p.imu_in_body) - rotate_inv(q, torch.cat([x[..., WV], pad], -1))
    ab = rotate_inv(q, x[..., ACC]) - cross(rr, cross(rr, p.imu_in_body))
    rr = rr.expand_as(vb)
    return fossen_efforts(m, torch.cat([ab, torch.zeros_like(ab)], -1), torch.cat([vb, rr], -1), q)

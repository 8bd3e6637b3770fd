"""Accelerometer: the specific force of the navigation-frame acceleration
and gravity, in the body frame, plus the accelerometer bias."""

import torch

from portbench.reference.pose_ukf import ACC, BA, GRAV, QUAT, rotate_inv

AUX_OPERANDS = 0


def h(x, p, aux):
    g = torch.cat([torch.zeros_like(x[..., 0:2]), x[..., GRAV]], dim=-1)
    return rotate_inv(x[..., QUAT], x[..., ACC] + g) + x[..., BA]

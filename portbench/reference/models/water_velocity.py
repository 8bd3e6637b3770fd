"""ADCP: the cell-weighted blend of the currents at and below the vehicle,
seen from the moving vehicle, plus the ADCP bias, χ²-95 gated; ``aux`` is
the (S,) cell weighting."""

import torch

from portbench.reference.pose_ukf import BADCP, CHI2_95_2DOF, QUAT, VEL, WV, WVB, rotate_inv

AUX_OPERANDS = 1  # the cell weighting
GATE = CHI2_95_2DOF


def h(x, p, aux):
    c = aux[..., None]
    pad = torch.zeros_like(x[..., 0:1])
    below = rotate_inv(x[..., QUAT], x[..., VEL] - torch.cat([x[..., WVB], pad], -1))[..., :2]
    at = rotate_inv(x[..., QUAT], x[..., VEL] - torch.cat([x[..., WV], pad], -1))[..., :2]
    return c * below + (1.0 - c) * at + x[..., BADCP]

"""DVL: the velocity in the body frame."""

from portbench.reference.pose_ukf import QUAT, VEL, rotate_inv

AUX_OPERANDS = 0


def h(x, p, aux):
    return rotate_inv(x[..., QUAT], x[..., VEL])

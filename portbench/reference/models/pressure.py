"""Pressure: the atmospheric pressure plus the water column above the
vehicle, p_atm − z·g·ρ (z up)."""

AUX_OPERANDS = 1  # the atmospheric pressure


def h(x, p, aux):
    return (p.p_atm - x[..., 2] * x[..., 19] * x[..., 53])[..., None]

"""Measurement validation — the counterpart of
``slam_uwv_kalman_filters_tpu/utils/validation.py`` (the reference's
``checkMeasurment(mu, cov)``): a host-side check that raises, and a
per-instance validity mask for bank updates.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["check_measurement", "measurement_valid"]


def check_measurement(mu, cov) -> None:
    """Raise ValueError on NaN/Inf or on a non-PSD-looking covariance."""
    mu = np.asarray(mu.cpu() if isinstance(mu, torch.Tensor) else mu)
    cov = np.asarray(cov.cpu() if isinstance(cov, torch.Tensor) else cov)
    if not np.all(np.isfinite(mu)):
        raise ValueError(f"measurement mean contains NaN/Inf: {mu}")
    if not np.all(np.isfinite(cov)):
        raise ValueError(f"measurement covariance contains NaN/Inf: {cov}")
    if cov.ndim == 2:
        if not np.allclose(cov, cov.T, atol=1e-9 * max(1.0, float(np.abs(cov).max()))):
            raise ValueError("measurement covariance is not symmetric")
        if np.any(np.diag(cov) < 0):
            raise ValueError("measurement covariance has negative variance")
    elif np.any(cov < 0):
        raise ValueError("measurement covariance has negative variance")


def measurement_valid(mu, cov, *, banked: bool | None = None) -> torch.Tensor:
    """Finite mean/cov and non-negative variances, as a mask: a scalar for
    one ``(d,)`` measurement, ``(B,)`` for a ``(B, d)`` bank. ``banked``
    disambiguates a ``(B,)`` bank of scalar measurements; a ``(B, d)``
    covariance equal in shape to ``mu`` holds per-instance variances."""
    mu = torch.as_tensor(mu)
    cov = torch.as_tensor(cov)
    if banked is None:
        banked = mu.ndim >= 2
    bank_axes = 1 if banked else 0

    ok_mu = torch.isfinite(mu).flatten(bank_axes).all(-1) if mu.ndim > bank_axes else torch.isfinite(mu)

    def matrix_ok(c):
        diag = torch.diagonal(c, dim1=-2, dim2=-1)
        return torch.isfinite(c).flatten(-2).all(-1) & (diag >= 0).all(-1)

    def variances_ok(c, per_row: bool):
        ok = torch.isfinite(c) & (c >= 0)
        return ok.all(-1) if per_row else ok

    scalar_meas = mu.ndim <= bank_axes
    if banked:
        b = mu.shape[0]
        if cov.ndim == 3:
            ok_cov = matrix_ok(cov)
        elif cov.ndim == 2 and not scalar_meas and cov.shape == mu.shape:
            ok_cov = variances_ok(cov, True)
        elif cov.ndim == 2:
            ok_cov = matrix_ok(cov)
        elif cov.ndim == 1 and scalar_meas and cov.shape[0] == b:
            ok_cov = variances_ok(cov, False)
        elif cov.ndim == 1:
            ok_cov = variances_ok(cov, True)
        else:
            ok_cov = variances_ok(cov, False)
    else:
        if cov.ndim == 2:
            ok_cov = matrix_ok(cov)
        elif cov.ndim == 1:
            ok_cov = variances_ok(cov, True)
        else:
            ok_cov = variances_ok(cov, False)
    return ok_mu & ok_cov

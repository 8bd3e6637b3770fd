"""Filter observability metrics — the counterpart of
``slam_uwv_kalman_filters_tpu/utils/metrics.py``: NIS/NEES, the covariance
condition number, ATE and heading error, and the per-update record.

Where JAX maps the one-instance forms with ``vmap``, these take batched
inputs: every function broadcasts over leading axes. All of them run on the
inputs' device; only :func:`covariance_condition` reads to the host (the
error check of ``torch.linalg.eigvalsh`` on the card).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "nis",
    "nees",
    "covariance_condition",
    "ate_rmse",
    "heading_error",
    "StepMetrics",
    "step_metrics",
]


def _quadratic_form(v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """vᵀA⁻¹v over leading axes of ``v`` (..., m) and ``a`` (..., m, m); a
    singular A gives NaN, where ``torch.linalg.solve`` would raise."""
    x, info = torch.linalg.solve_ex(a, v.unsqueeze(-1))
    q = (v * x.squeeze(-1)).sum(-1)
    return torch.where(info == 0, q, torch.full_like(q, float("nan")))


def nis(innovation: torch.Tensor, innovation_cov: torch.Tensor) -> torch.Tensor:
    """Normalized innovation squared νᵀS⁻¹ν (χ²_m under consistency).

    ``ops.ukf.UpdateInfo.mahalanobis2`` already carries this for each update;
    this standalone form is for offline analysis."""
    return _quadratic_form(innovation, innovation_cov)


def nees(error: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """Normalized estimation error squared eᵀP⁻¹e (χ²_n under consistency)."""
    return _quadratic_form(error, cov)


def covariance_condition(cov: torch.Tensor) -> torch.Tensor:
    """Condition number of (..., n, n) symmetric ``cov`` from its eigenvalue
    MAGNITUDES: an indefinite covariance (float32 cancellation flipping an
    eigenvalue to -1000) reports a huge condition number, not a small one. A
    collapsed covariance (some |eigenvalue| exactly 0) reports ``inf``
    behind a guard divisor representable in the working dtype. A matrix
    with a NaN or Inf entry reports NaN (JAX's select turns its NaN
    eigenvalues into the collapsed answer, inf): ``torch.linalg.eigvalsh``
    raises on one, so the identity is factored in its place and NaN is
    selected back."""
    finite = torch.isfinite(cov).all(dim=-1).all(dim=-1)
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    w = torch.linalg.eigvalsh(torch.where(finite[..., None, None], cov, eye)).abs()
    num = w.amax(dim=-1)
    den = w.amin(dim=-1)
    tiny = torch.finfo(w.dtype).tiny
    cond = torch.where(den > 0, num / den.clamp(min=tiny), torch.full_like(num, float("inf")))
    return torch.where(finite, cond, torch.full_like(cond, float("nan")))


def ate_rmse(estimated: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    """Absolute trajectory error (RMSE over positions, no alignment)."""
    d = estimated - truth
    return torch.sqrt(torch.mean(torch.sum(d * d, dim=-1)))


def heading_error(q_est: torch.Tensor, q_true: torch.Tensor) -> torch.Tensor:
    """Yaw difference between two [w,x,y,z] quaternions (rad), wrapped to
    (-π, π]."""

    def yaw(q):
        w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
        return torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))

    d = yaw(q_est) - yaw(q_true)
    return torch.atan2(torch.sin(d), torch.cos(d))


class StepMetrics(NamedTuple):
    nis: torch.Tensor
    accepted: torch.Tensor
    cov_trace: torch.Tensor
    cov_condition: torch.Tensor


def step_metrics(info, cov: torch.Tensor, *, with_condition: bool = False) -> StepMetrics:
    """Per-update metrics record from an ``ops.ukf.UpdateInfo`` and the
    (..., n, n) covariance after the update."""
    trace = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1)
    cond = covariance_condition(cov) if with_condition else torch.zeros_like(trace)
    return StepMetrics(nis=info.mahalanobis2, accepted=info.accepted, cov_trace=trace, cov_condition=cond)

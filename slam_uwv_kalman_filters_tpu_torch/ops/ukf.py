"""Manifold unscented Kalman filter core — the counterpart of
``slam_uwv_kalman_filters_tpu/ops/ukf.py`` (the reference's ``ukfom::ukf``).

ukfom conventions, as in the JAX package:

* 2n+1 sigma points: X₀ = μ, X_{2j+1} = μ ⊞ Lⱼ, X_{2j+2} = μ ⊞ (−Lⱼ),
  L = chol(P) (unit spread).
* Mean: equal-weight iterative manifold mean started from X₀.
* Covariances: ½·Σᵢ outer products of ⊟-deviations.
* Update: fresh sigma points; S = ½ΣdZdZᵀ + R; C = ½ΣδdZᵀ; K = C·S⁻¹; χ²
  gate on νᵀS⁻¹ν as a masked select, never control flow. A measurement on a
  manifold (S²) takes its mean on the manifold, and dZ and ν are ⊟ at it.
* Smoothing: the unscented RTS step of the JAX package's ``smooth_step``,
  its gain from the banked SPD solve (kernel K8 on a CUDA tensor).

Where JAX vmapped a per-instance function, these functions take a bank:
every field of ``mu`` has a leading bank axis (B, ...), ``cov`` is
(B, n, n). Sigma points carry the sigma axis first, (2n+1, B, ...), so a
process or measurement model written for broadcasting serves both. The
sigma deltas go through ``ops.kernels.sigma_deltas_banked`` (kernel K1 on a
CUDA tensor).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from .kernels import sigma_deltas_banked, solve_spd_banked
from .linalg_small import solve_spd
from .manifolds import ProductManifold

__all__ = [
    "D2P95",
    "D2P99",
    "UpdateInfo",
    "augment_covariance",
    "sigma_point_deltas",
    "sigma_points",
    "predict",
    "update",
    "smooth_step",
]

# χ² gate thresholds for 2 degrees of freedom
D2P99 = 9.21
D2P95 = 5.991


class UpdateInfo(NamedTuple):
    """Per-update record: NIS, gate outcome and innovation (bank-first)."""

    mahalanobis2: torch.Tensor  # (B,)
    accepted: torch.Tensor  # (B,) bool
    innovation: torch.Tensor  # (B, m)


def _default_tol(dtype) -> float:
    """Manifold-mean tolerance matched to the working precision."""
    return 1e-12 if dtype == torch.float64 else 1e-6


def _symmetrize(m: torch.Tensor) -> torch.Tensor:
    return 0.5 * (m + m.transpose(-1, -2))


def augment_covariance(cov: torch.Tensor, cov_aug: torch.Tensor) -> torch.Tensor:
    """The covariance of a bank augmented with independent states: (B, n, n)
    and (m, m) or (B, m, m) → (B, n+m, n+m), block diagonal with zero
    cross-covariance. Built by concatenation, not by writes into a zero
    tensor, so it takes blocks batched by ``torch.func.vmap``."""
    nb, n, m = cov.shape[0], cov.shape[-1], cov_aug.shape[-1]
    cov_aug = cov_aug.to(cov.dtype).expand(nb, m, m)
    top = torch.cat([cov, cov.new_zeros(nb, n, m)], dim=-1)
    return torch.cat([top, torch.cat([cov.new_zeros(nb, m, n), cov_aug], dim=-1)], dim=-2)


def sigma_point_deltas(cov: torch.Tensor, *, jitter: float = 0.0) -> torch.Tensor:
    """(B, n, n) → (B, 2n+1, n) tangent deltas: row 0 zero, then ±columns
    of chol(P) in ukfom's interleaved order."""
    if jitter:
        cov = cov + jitter * torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    return sigma_deltas_banked(cov)


def sigma_points(manifold: ProductManifold, mu: Any, cov: torch.Tensor, *, jitter: float = 0.0):
    """Sigma points of a bank as a mu-tree with leading (2n+1, B) axes."""
    deltas = sigma_point_deltas(cov, jitter=jitter)
    return manifold.boxplus(mu, deltas.transpose(0, 1))


def predict(
    manifold: ProductManifold,
    mu: Any,
    cov: torch.Tensor,
    f: Callable[[Any], Any],
    process_noise: torch.Tensor,
    *,
    jitter: float = 0.0,
    mean_iters: int = 64,
    mean_tol: Optional[float] = None,
):
    """Unscented prediction of a bank: (μ, P) → (μ⁺, P⁺) through the process
    model ``f`` (applied to the (2n+1, B)-batched sigma points)."""
    if mean_tol is None:
        mean_tol = _default_tol(cov.dtype)
    X = sigma_points(manifold, mu, cov, jitter=jitter)
    Y = f(X)
    mu_y = manifold.mean(Y, max_iters=mean_iters, tol=mean_tol)
    mu_y = type(mu_y)(*[a.to(ref.dtype) for a, ref in zip(mu_y, mu)])
    D = manifold.boxminus(Y, mu_y).to(cov.dtype).permute(1, 0, 2)  # (B, 2n+1, n)
    cov_y = 0.5 * (D.transpose(1, 2) @ D) + process_noise
    return mu_y, _symmetrize(cov_y).to(cov.dtype)


def update(
    manifold: ProductManifold,
    mu: Any,
    cov: torch.Tensor,
    z: torch.Tensor,
    h: Callable[[Any], torch.Tensor],
    meas_cov: torch.Tensor,
    *,
    meas_manifold=None,
    gate_threshold: Optional[float] = None,
    jitter: float = 0.0,
    mean_iters: int = 64,
    mean_tol: Optional[float] = None,
):
    """Unscented measurement update of a bank. ``h`` maps the (2n+1, B)
    sigma points to (2n+1, B, m), or with ``meas_manifold`` (e.g.
    ``manifolds.S2_MANIFOLD``) to points of that manifold, whose mean is
    then iterative and whose deviations and innovation are ⊟ at it; ``z`` is
    (B, m) or (B, …) on the manifold; ``meas_cov`` (m, m) or (B, m, m).
    ``gate_threshold=None`` accepts any measurement."""
    if mean_tol is None:
        mean_tol = _default_tol(cov.dtype)
    deltas = sigma_point_deltas(cov, jitter=jitter)  # (B, 2n+1, n) == X_i ⊟ mu
    X = manifold.boxplus(mu, deltas.transpose(0, 1))
    Z = h(X)  # (2n+1, B, m)
    if meas_manifold is None:
        z_mean = Z.mean(dim=0)
        dZ = Z - z_mean[None]
        innovation = z - z_mean
    else:
        z_mean = meas_manifold.mean(Z, max_iters=mean_iters, tol=mean_tol)
        dZ = meas_manifold.boxminus(Z, z_mean[None])
        innovation = meas_manifold.boxminus(z, z_mean)
    dZ = dZ.to(cov.dtype).permute(1, 0, 2)  # (B, 2n+1, m)
    innovation = innovation.to(cov.dtype)
    meas_cov = torch.as_tensor(meas_cov, dtype=cov.dtype, device=cov.device)

    S = _symmetrize(0.5 * (dZ.transpose(1, 2) @ dZ) + meas_cov)
    C = 0.5 * (deltas.transpose(1, 2) @ dZ)  # (B, n, m) cross-covariance

    rhs = torch.cat([C.transpose(1, 2), innovation[..., None]], dim=-1)  # (B, m, n+1)
    sol = solve_spd(S, rhs)
    K = sol[..., :-1].transpose(1, 2)  # K = C S⁻¹
    m2 = (innovation * sol[..., -1]).sum(-1)

    if gate_threshold is None:
        accepted = torch.ones_like(m2, dtype=torch.bool)
    else:
        accepted = m2 <= torch.as_tensor(gate_threshold, dtype=m2.dtype, device=m2.device)

    mu_new = manifold.boxplus(mu, (K @ innovation[..., None])[..., 0])
    cov_new = _symmetrize(cov - K @ S @ K.transpose(1, 2))

    def select(a, b):
        return torch.where(accepted.reshape(accepted.shape + (1,) * (a.ndim - 1)), a, b)

    mu_out = type(mu)(*[select(a, b) for a, b in zip(mu_new, mu)])
    return mu_out, select(cov_new, cov), UpdateInfo(m2, accepted, innovation)


def smooth_step(
    manifold: ProductManifold,
    mu_f: Any,
    cov_f: torch.Tensor,
    f: Callable[[Any], Any],
    process_noise: torch.Tensor,
    mu_s_next: Any,
    cov_s_next: torch.Tensor,
    *,
    jitter: float = 0.0,
    mean_iters: int = 64,
    mean_tol: Optional[float] = None,
):
    """One backward unscented Rauch–Tung–Striebel step of a bank: the
    filtered (μ, P) of tick k with the smoothed (μˢ, Pˢ) of tick k+1,
    through the forward pass's process model ``f`` and noise (B, n, n):

        χᵢ = μ ⊞ δᵢ,  Υᵢ = f(χᵢ),  μ⁻ = mean(Υ)
        P⁻ = ½ΣDDᵀ + Q,  C = ½ΣδDᵀ,  G = C·(P⁻)⁻¹ (SPD solve P⁻Gᵀ = Cᵀ)
        μˢₖ = μ ⊞ G·(μˢₖ₊₁ ⊟ μ⁻),  Pˢₖ = P + G·(Pˢₖ₊₁ − P⁻)·Gᵀ (symmetrized)
    """
    if mean_tol is None:
        mean_tol = _default_tol(cov_f.dtype)
    deltas = sigma_point_deltas(cov_f, jitter=jitter)  # (B, 2n+1, n)
    Y = f(manifold.boxplus(mu_f, deltas.transpose(0, 1)))
    mu_pred = manifold.mean(Y, max_iters=mean_iters, tol=mean_tol)
    mu_pred = type(mu_pred)(*[a.to(ref.dtype) for a, ref in zip(mu_pred, mu_f)])
    D = manifold.boxminus(Y, mu_pred).to(cov_f.dtype).permute(1, 0, 2)  # (B, 2n+1, n)
    cov_pred = _symmetrize(0.5 * (D.transpose(1, 2) @ D) + process_noise).to(cov_f.dtype)
    C = 0.5 * (deltas.transpose(1, 2) @ D)  # (B, n, n) cross-covariance cov(x_k, x_pred)
    G = solve_spd_banked(cov_pred, C.transpose(1, 2)).transpose(1, 2)
    mu_s = manifold.boxplus(mu_f, (G @ manifold.boxminus(mu_s_next, mu_pred)[..., None])[..., 0])
    cov_s = _symmetrize(cov_f + G @ (cov_s_next - cov_pred) @ G.transpose(1, 2))
    return mu_s, cov_s

"""Unrolled small-matrix linear algebra — the counterpart of
``slam_uwv_kalman_filters_tpu/ops/linalg_small.py``.

Every matrix on the measurement side of the UKF is tiny and of static size
(1–6: the measurement dimensions; 6×6 for the Fossen inertia matrix), so
Cholesky and the triangular substitutions are unrolled into scalar
operations on whole batches: ``S`` is ``(..., m, m)`` and every scalar of the
factor is a ``(...)`` tensor.
"""

from __future__ import annotations

import torch

__all__ = ["cholesky_unrolled", "solve_spd", "UNROLL_LIMIT"]

UNROLL_LIMIT = 8  # beyond this, the library Cholesky


def _scalar_cholesky_factors(S: torch.Tensor):
    """Scalar lower-triangular factor grid L[i][j] (i ≥ j), Cholesky–Crout
    fully unrolled."""
    m = S.shape[-1]
    L = [[None] * m for _ in range(m)]
    for j in range(m):
        s = S[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(s)
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, m):
            t = S[..., i, j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t * inv_d
    return L


def cholesky_unrolled(S: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of a batch of small SPD matrices."""
    m = S.shape[-1]
    L = _scalar_cholesky_factors(S)
    zero = torch.zeros_like(L[0][0])
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(m)], dim=-1) for i in range(m)]
    return torch.stack(rows, dim=-2)


def _solve_spd_unrolled(S: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """S⁻¹B for S (..., m, m) and B (..., m, k)."""
    m = S.shape[-1]
    L = _scalar_cholesky_factors(S)
    inv_diag = [(1.0 / L[i][i])[..., None] for i in range(m)]
    y = [None] * m
    for i in range(m):  # forward substitution L y = B
        t = B[..., i, :]
        for k in range(i):
            t = t - L[i][k][..., None] * y[k]
        y[i] = t * inv_diag[i]
    x = [None] * m
    for i in reversed(range(m)):  # back substitution Lᵀ x = y
        t = y[i]
        for k in range(i + 1, m):
            t = t - L[k][i][..., None] * x[k]
        x[i] = t * inv_diag[i]
    return torch.stack(x, dim=-2)


def solve_spd(S: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """S⁻¹B for SPD S (..., m, m) and B (..., m, k) — unrolled when the
    static size permits, the library Cholesky solve otherwise."""
    if S.shape[-1] <= UNROLL_LIMIT:
        return _solve_spd_unrolled(S, B)
    return torch.cholesky_solve(B, torch.linalg.cholesky(S))

"""Sigma-point deltas and the banked SPD solve of the generic UKF — kernels
K1 and K8 and their plain versions.

Counterpart of ``slam_uwv_kalman_filters_tpu/ops/kernels.py``: the fused
equilibrated Cholesky → ±column sigma deltas (``_sigma_deltas_kernel`` and
its core ``equilibrated_sigma_columns``), and the equilibrated Cholesky →
two triangular substitutions X = A⁻¹B (``_solve_spd_kernel``). On a CUDA
tensor :func:`sigma_deltas_banked` (bank-first) and
:func:`sigma_deltas_lanes` (bank-last, the lanes layout of
``models/pose_fused.py``) launch the hand-written kernel of
``csrc/sigma_deltas.cu``, and :func:`solve_spd_banked` that of
``csrc/solve_spd.cu``; on a CPU tensor they run the plain version.

The deltas are ukfom-ordered: row 0 zero, rows 2j+1 / 2j+2 the ±j-th column
of L = D·chol(D⁻¹·A·D⁻¹), D = √max(diag A, tiny). The diagonal equilibration
matters: the 53-DOF PoseUKF covariance mixes variances from ~1e-11 to ~1e1
(condition ~1e12), beyond float32 without it.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .linalg_small import UNROLL_LIMIT, cholesky_unrolled, solve_spd

__all__ = [
    "MAX_N",
    "equilibrated_cholesky",
    "sigma_deltas_banked",
    "sigma_deltas_cuda",
    "sigma_deltas_lanes",
    "sigma_deltas_lanes_cuda",
    "sigma_deltas_lanes_plain",
    "sigma_deltas_plain",
    "solve_spd_banked",
    "solve_spd_cuda",
    "solve_spd_lanes_cuda",
    "solve_spd_lanes_plain",
    "solve_spd_plain",
]

MAX_N = 64  # largest matrix the CUDA core takes (per-thread local arrays)


def equilibrated_cholesky(cov: torch.Tensor):
    """(L̃, d) with L̃ = chol(D⁻¹·cov·D⁻¹) and d = √max(diag cov, tiny), for
    (..., n, n) SPD ``cov`` (lower triangle read). A failed factorization
    gives NaN, as LAPACK-backed JAX does, instead of raising."""
    tiny = torch.finfo(cov.dtype).tiny
    d = torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1), min=tiny))
    corr = cov / (d[..., :, None] * d[..., None, :])
    lt, info = torch.linalg.cholesky_ex(corr)
    lt = torch.where((info == 0)[..., None, None], lt, torch.full_like(lt, float("nan")))
    return lt, d


def sigma_deltas_plain(cov: torch.Tensor) -> torch.Tensor:
    """(N, n, n) SPD batch → (N, 2n+1, n) ukfom sigma deltas, in PyTorch.
    n ≤ 8 factors unrolled without equilibration, as the JAX fallback does."""
    nb, n = cov.shape[0], cov.shape[-1]
    if n <= UNROLL_LIMIT:
        L = cholesky_unrolled(cov)
    else:
        lt, d = equilibrated_cholesky(cov)
        L = lt * d[:, :, None]
    cols = L.transpose(-1, -2)  # row j = column j of L
    pm = torch.stack([cols, -cols], dim=-2).reshape(nb, 2 * n, n)
    return torch.cat([torch.zeros(nb, 1, n, dtype=cov.dtype, device=cov.device), pm], dim=-2)


def _mirror_half(a_t: torch.Tensor) -> torch.Tensor:
    """Symmetric (n, n, N) matrices from half-valid ones (valid at
    [c, r ≥ c]; the other half is never read)."""
    n = a_t.shape[0]
    keep = torch.triu(torch.ones((n, n), dtype=torch.bool, device=a_t.device))[..., None]
    return torch.where(keep, a_t, a_t.transpose(0, 1))


def sigma_deltas_lanes_plain(a_t: torch.Tensor) -> torch.Tensor:
    """(n, n, N) lanes covariance, valid at [c, r ≥ c] → (2n+1, n, N) sigma
    deltas, in PyTorch."""
    return sigma_deltas_plain(_mirror_half(a_t).permute(2, 1, 0)).permute(1, 2, 0).contiguous()


def sigma_deltas_lanes_cuda(a_t: torch.Tensor) -> torch.Tensor:
    """K1 on the card in its own layout: (n, n, N) lanes covariance, valid at
    [c, r ≥ c], → (2n+1, n, N), one thread per instance."""
    n, nb = a_t.shape[0], a_t.shape[-1]
    if a_t.ndim != 3 or a_t.shape[1] != n or not 1 <= n <= MAX_N or nb < 1:
        raise ValueError(f"sigma_deltas: need (n, n, N) with n <= {MAX_N}, got {tuple(a_t.shape)}")
    out_t = torch.empty((2 * n + 1, n, nb), dtype=a_t.dtype, device=a_t.device)
    scratch = torch.empty((n, n, nb), dtype=a_t.dtype, device=a_t.device)
    cuda_lib.check_lanes("sigma_deltas", a_t.device, a_t.dtype, a_t=a_t, out_t=out_t, scratch=scratch)
    cuda_lib.KERNELS["sigma_deltas"].launch(
        a_t.dtype, a_t.data_ptr(), out_t.data_ptr(), scratch.data_ptr(), n, nb,
        cuda_lib.stream_ptr(a_t.device),
    )
    return out_t


def sigma_deltas_cuda(cov: torch.Tensor) -> torch.Tensor:
    """K1 on the card: (N, n, n) → (N, 2n+1, n). The kernel runs in the
    bank-last (col, row, N) layout; the layout transposes are plain PyTorch
    copies around it."""
    if cov.ndim != 3 or cov.shape[1] != cov.shape[2]:
        raise ValueError(f"sigma_deltas_cuda: need (N, n, n), got {tuple(cov.shape)}")
    return sigma_deltas_lanes_cuda(cov.permute(2, 1, 0).contiguous()).permute(2, 0, 1)


def sigma_deltas_lanes(a_t: torch.Tensor) -> torch.Tensor:
    """(n, n, N) half-valid lanes covariance → (2n+1, n, N) sigma deltas, as
    it stands (no permute, no mirror): the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. The counterpart of JAX
    ``_sigma_deltas_lanes(lstate.cov_t)``."""
    if a_t.device.type == "cuda":
        return sigma_deltas_lanes_cuda(a_t.contiguous())
    if a_t.device.type == "cpu":
        return sigma_deltas_lanes_plain(a_t)
    raise ValueError(f"sigma_deltas_lanes: no path for device {a_t.device}")


def sigma_deltas_banked(cov: torch.Tensor) -> torch.Tensor:
    """(N, n, n) or (n, n) SPD → ukfom sigma deltas: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    single = cov.ndim == 2
    if single:
        cov = cov[None]
    if cov.device.type == "cuda":
        out = sigma_deltas_cuda(cov)
    elif cov.device.type == "cpu":
        out = sigma_deltas_plain(cov)
    else:
        raise ValueError(f"sigma_deltas_banked: no path for device {cov.device}")
    return out[0] if single else out


# ---------------------------------------------------------------------------
# K8: X = A⁻¹B for a bank of SPD systems
# ---------------------------------------------------------------------------


def solve_spd_plain(spd: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(N, n, n) SPD (lower triangle read), (N, n, k) → (N, n, k) A⁻¹B in
    PyTorch, as K8 computes it: the equilibrated factor L = D·chol(D⁻¹AD⁻¹),
    then L·Y = B and Lᵀ·X = Y. A failed factorization gives NaN."""
    lt, d = equilibrated_cholesky(spd)
    L = lt * d[..., :, None]
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


def solve_spd_lanes_plain(a_t: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """K8's function in its own layout, in PyTorch: (n, n, N) systems valid at
    [c, r ≥ c], (n, k, N) right-hand sides → (n, k, N)."""
    return solve_spd_plain(_mirror_half(a_t).permute(2, 1, 0), b_t.permute(2, 0, 1)).permute(1, 2, 0).contiguous()


def solve_spd_lanes_cuda(a_t: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """K8 on the card in its own layout: (n, n, N) systems valid at
    [c, r ≥ c], (n, k, N) right-hand sides → (n, k, N): a factor pass (one
    thread per system) and a substitution pass (one thread per system and
    right-hand side), both in one launch call."""
    n, nb = a_t.shape[0], a_t.shape[-1]
    if a_t.ndim != 3 or a_t.shape[1] != n or not 1 <= n <= MAX_N or nb < 1:
        raise ValueError(f"solve_spd: need (n, n, N) systems with n <= {MAX_N}, got {tuple(a_t.shape)}")
    if b_t.ndim != 3 or b_t.shape[0] != n or b_t.shape[2] != nb or b_t.shape[1] < 1:
        raise ValueError(f"solve_spd: need (n={n}, k, N={nb}) right-hand sides, got {tuple(b_t.shape)}")
    k = b_t.shape[1]
    out_t = torch.empty((n, k, nb), dtype=a_t.dtype, device=a_t.device)
    scratch = torch.empty((n + 1, n, nb), dtype=a_t.dtype, device=a_t.device)  # the factor, then D
    cuda_lib.check_lanes("solve_spd", a_t.device, a_t.dtype, a_t=a_t, b_t=b_t, out_t=out_t, scratch=scratch)
    cuda_lib.KERNELS["solve_spd"].launch(
        a_t.dtype, a_t.data_ptr(), b_t.data_ptr(), out_t.data_ptr(), scratch.data_ptr(), n, k, nb,
        cuda_lib.stream_ptr(a_t.device),
    )
    return out_t


def solve_spd_cuda(spd: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """K8 on the card: (N, n, n), (N, n, k) → (N, n, k); the layout
    transposes are plain PyTorch copies around the kernel."""
    x_t = solve_spd_lanes_cuda(spd.permute(2, 1, 0).contiguous(), rhs.permute(1, 2, 0).contiguous())
    return x_t.permute(2, 0, 1)


def solve_spd_banked(spd: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """A⁻¹B for SPD ``spd`` (N, n, n) or (n, n) and ``rhs`` (N, n, k) or
    (n, k): n ≤ ``UNROLL_LIMIT`` by the unrolled substitution of
    ``linalg_small`` on any device; larger n by K8 for a CUDA tensor (any
    bank, float32 or float64) and by :func:`solve_spd_plain` for a CPU
    tensor. It serves JAX's ``solve_spd_fast`` (one system) too: the port
    has no ``vmap`` to batch it."""
    single = spd.ndim == 2
    if single:
        spd, rhs = spd[None], rhs[None]
    if spd.shape[-1] <= UNROLL_LIMIT:
        out = solve_spd(spd, rhs)
    elif spd.device.type == "cuda":
        out = solve_spd_cuda(spd, rhs)
    elif spd.device.type == "cpu":
        out = solve_spd_plain(spd, rhs)
    else:
        raise ValueError(f"solve_spd_banked: no path for device {spd.device}")
    return out[0] if single else out


"""The banked Cholesky, the sigma-point deltas and the banked SPD solve of
the generic UKF — kernels K12, K1 and K8 and their plain versions.

Counterpart of ``slam_uwv_kalman_filters_tpu/ops/kernels.py``: the banked
lower Cholesky (``_cholesky_lanes_kernel``, entry points ``cholesky_banked``
and ``cholesky_fast``), the fused equilibrated Cholesky → ±column sigma
deltas (``_sigma_deltas_kernel`` and its core
``equilibrated_sigma_columns``), and the equilibrated Cholesky → two
triangular substitutions X = A⁻¹B (``_solve_spd_kernel``). On a CUDA tensor
:func:`cholesky_banked` launches the hand-written kernel of
``csrc/cholesky.cu``, :func:`sigma_deltas_banked` (bank-first) and
:func:`sigma_deltas_lanes` (bank-last, the lanes layout of
``models/pose_fused.py``) that of ``csrc/sigma_deltas.cu``, and
:func:`solve_spd_banked` that of ``csrc/solve_spd.cu``; on a CPU tensor they
run the plain version. Each is also an op (``slam_uwv::sigma_deltas_lanes``,
``sigma_deltas``, ``solve_spd``, ``cholesky``; ``cuda_lib.kernel_op``), which
they call under ``torch.export`` and under ``torch.func.vmap``. Each op has a
vmap rule, the counterpart of JAX's ``custom_vmap`` rules of
``sigma_deltas_fast``, ``cholesky_fast`` and ``solve_spd_fast``: the vmapped
axes fold into the kernel's bank axis, so a function written for one filter
and vmapped over a bank makes one launch per call, not one per instance.

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
    "cholesky_banked",
    "cholesky_cuda",
    "cholesky_fast",
    "cholesky_lanes_cuda",
    "cholesky_lanes_plain",
    "cholesky_plain",
    "equilibrated_cholesky",
    "equilibrated_factor",
    "sigma_deltas_banked",
    "sigma_deltas_cuda",
    "sigma_deltas_fast",
    "sigma_deltas_lanes",
    "sigma_deltas_lanes_cuda",
    "sigma_deltas_lanes_plain",
    "sigma_deltas_plain",
    "solve_spd_banked",
    "solve_spd_cuda",
    "solve_spd_fast",
    "solve_spd_lanes_cuda",
    "solve_spd_lanes_plain",
    "solve_spd_plain",
]

MAX_N = 64  # largest matrix the CUDA cores take (K1, K8, K12: two rows a lane)


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


def equilibrated_factor(cov: torch.Tensor) -> torch.Tensor:
    """L = D·chol(D⁻¹·cov·D⁻¹) of (..., n, n) SPD ``cov`` (lower triangle
    read), D = √max(diag cov, tiny): the factor K1, K8 and K12 compute. A
    failed factorization gives NaN."""
    lt, d = equilibrated_cholesky(cov)
    return lt * d[..., :, None]


def cholesky_plain(cov: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of an (N, n, n) SPD batch in PyTorch, as JAX's
    ``cholesky_banked`` computes it: n ≤ ``UNROLL_LIMIT`` unrolled without
    equilibration, larger n the equilibrated factor. Only the lower triangle
    is read; a failed factorization gives NaN."""
    if cov.shape[-1] <= UNROLL_LIMIT:
        return cholesky_unrolled(cov)
    return equilibrated_factor(cov)


def sigma_deltas_plain(cov: torch.Tensor) -> torch.Tensor:
    """(N, n, n) SPD batch → (N, 2n+1, n) ukfom sigma deltas, in PyTorch:
    :func:`cholesky_plain` and the ± stack of its columns, as the JAX
    fallback composes ``cholesky_banked``."""
    nb, n = cov.shape[0], cov.shape[-1]
    L = cholesky_plain(cov)
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


def _strides(t: torch.Tensor, axes: tuple) -> tuple:
    """Element strides of ``t``'s (bank, row, col) axes, as K1 and K8 take
    them."""
    return tuple(t.stride(i) for i in axes)


def _factor_launch(name: str, a: torch.Tensor, a_axes: tuple, out: torch.Tensor, out_axes: tuple) -> torch.Tensor:
    """One launch of K1 or K12 (``name``): ``a`` read through the strides of
    its (bank, row, col) axes ``a_axes``, the result written into ``out``
    through ``out_axes`` (K1: row = sigma point, col = component)."""
    n, nb = a.shape[a_axes[1]], a.shape[a_axes[0]]
    cuda_lib.check_lanes(name, a.device, a.dtype, out=out)
    cuda_lib.check_lanes(name, a.device, a.dtype, contiguous=False, a=a)
    cuda_lib.KERNELS[name].launch(
        a.dtype, a.data_ptr(), *_strides(a, a_axes), out.data_ptr(), *_strides(out, out_axes), n, nb,
        cuda_lib.stream_ptr(a.device),
    )
    return out


def sigma_deltas_lanes_cuda(a_t: torch.Tensor) -> torch.Tensor:
    """K1 on the card in the lanes layout: (n, n, N) covariance, valid at
    [c, r ≥ c], any strides → (2n+1, n, N), one warp per instance."""
    n, nb = a_t.shape[0], a_t.shape[-1]
    if a_t.ndim != 3 or a_t.shape[1] != n or not 1 <= n <= MAX_N or nb < 1:
        raise ValueError(f"sigma_deltas: need (n, n, N) with n <= {MAX_N}, got {tuple(a_t.shape)}")
    out_t = torch.empty((2 * n + 1, n, nb), dtype=a_t.dtype, device=a_t.device)
    return _factor_launch("sigma_deltas", a_t, (2, 1, 0), out_t, (2, 0, 1))


def sigma_deltas_cuda(cov: torch.Tensor) -> torch.Tensor:
    """K1 on the card in the bank-first layout: (N, n, n), lower triangle
    read, any strides → (N, 2n+1, n), one warp per instance."""
    nb, n = cov.shape[0], cov.shape[-1]
    if cov.ndim != 3 or cov.shape[1] != n or not 1 <= n <= MAX_N or nb < 1:
        raise ValueError(f"sigma_deltas_cuda: need (N, n, n) with n <= {MAX_N}, got {tuple(cov.shape)}")
    out = torch.empty((nb, 2 * n + 1, n), dtype=cov.dtype, device=cov.device)
    return _factor_launch("sigma_deltas", cov, (0, 1, 2), out, (0, 1, 2))


def _bank_first_rule(call, in_dims, cov):
    """vmap rule of a bank-first one-operand op (K1, K12): (N, n, n) with a
    vmap dim of size V → one call on (V·N, n, n), unfolded to (V, N, …)."""
    (d,) = in_dims
    if d is None:
        return call(cov), None
    cov = cov.movedim(d, 0)
    out = call(cov.reshape(-1, *cov.shape[2:]))
    return out.reshape(*cov.shape[:2], *out.shape[1:]), 0


def _lanes_rule(call, in_dims, a_t):
    """vmap rule of the lanes op: (n, n, N) with a vmap dim of size V → one
    call on (n, n, V·N), unfolded to (2n+1, n, V, N)."""
    (d,) = in_dims
    if d is None:
        return call(a_t), None
    a_t = a_t.movedim(d, 2)
    out = call(a_t.reshape(*a_t.shape[:2], -1))
    return out.reshape(*out.shape[:2], *a_t.shape[2:]), 2


# the kernels as ops (``cuda_lib.kernel_op``): the CUDA wrapper on the card, the
# plain version on the CPU, each looked up when called
_new = lambda t, *shape: t.new_empty(shape)
_SIGMA_DELTAS_LANES = cuda_lib.kernel_op(
    "sigma_deltas_lanes", "(Tensor a_t) -> Tensor",
    lambda a_t: sigma_deltas_lanes_cuda(a_t), lambda a_t: sigma_deltas_lanes_plain(a_t),
    lambda a_t: _new(a_t, 2 * a_t.shape[0] + 1, a_t.shape[0], a_t.shape[-1]), vmap=_lanes_rule,
)
_SIGMA_DELTAS = cuda_lib.kernel_op(
    "sigma_deltas", "(Tensor cov) -> Tensor",
    lambda cov: sigma_deltas_cuda(cov), lambda cov: sigma_deltas_plain(cov),
    lambda cov: _new(cov, cov.shape[0], 2 * cov.shape[-1] + 1, cov.shape[-1]), vmap=_bank_first_rule,
)


def sigma_deltas_lanes(a_t: torch.Tensor) -> torch.Tensor:
    """(n, n, N) half-valid lanes covariance → (2n+1, n, N) sigma deltas, as
    it stands (no permute, no mirror): the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. The counterpart of JAX
    ``_sigma_deltas_lanes(lstate.cov_t)``."""
    cuda_lib.route("sigma_deltas_lanes", a_t)
    return _SIGMA_DELTAS_LANES(a_t)


def sigma_deltas_banked(cov: torch.Tensor) -> torch.Tensor:
    """(N, n, n) or (n, n) SPD → ukfom sigma deltas: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    single = cov.ndim == 2
    if single:
        cov = cov[None]
    cuda_lib.route("sigma_deltas_banked", cov)
    out = _SIGMA_DELTAS(cov)
    return out[0] if single else out


def sigma_deltas_fast(cov: torch.Tensor) -> torch.Tensor:
    """ukfom sigma deltas of one (n, n) SPD matrix or of any (..., n, n)
    stack → (..., 2n+1, n): the leading axes flatten into one bank for
    :func:`sigma_deltas_banked` (K1 on the card). Under ``torch.func.vmap``
    the op's rule folds the vmapped axes into that bank too, so a vmapped
    call on one matrix is one launch, as JAX's vmap rule of
    ``sigma_deltas_fast`` makes it."""
    n = cov.shape[-1]
    if cov.ndim == 2:
        return sigma_deltas_banked(cov)
    return sigma_deltas_banked(cov.reshape(-1, n, n)).reshape(*cov.shape[:-2], 2 * n + 1, n)


# ---------------------------------------------------------------------------
# K8: X = A⁻¹B for a bank of SPD systems
# ---------------------------------------------------------------------------


def solve_spd_plain(spd: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(N, n, n) SPD (lower triangle read), (N, n, k) → (N, n, k) A⁻¹B in
    PyTorch, as K8 computes it: the equilibrated factor L = D·chol(D⁻¹AD⁻¹),
    then L·Y = B and Lᵀ·X = Y. A failed factorization gives NaN."""
    L = equilibrated_factor(spd)
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


def solve_spd_lanes_plain(a_t: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """K8's function in its own layout, in PyTorch: (n, n, N) systems valid at
    [c, r ≥ c], (n, k, N) right-hand sides → (n, k, N)."""
    return solve_spd_plain(_mirror_half(a_t).permute(2, 1, 0), b_t.permute(2, 0, 1)).permute(1, 2, 0).contiguous()


def _solve_spd_launch(a: torch.Tensor, a_axes: tuple, b: torch.Tensor, b_axes: tuple, x: torch.Tensor,
                      x_axes: tuple) -> torch.Tensor:
    """One K8 launch: each tensor read or written through the strides of its
    (bank, row, col) axes."""
    n, nb, k = a.shape[a_axes[1]], a.shape[a_axes[0]], b.shape[b_axes[2]]
    cuda_lib.check_lanes("solve_spd", a.device, a.dtype, x=x)
    cuda_lib.check_lanes("solve_spd", a.device, a.dtype, contiguous=False, a=a, b=b)
    cuda_lib.KERNELS["solve_spd"].launch(
        a.dtype, a.data_ptr(), *_strides(a, a_axes), b.data_ptr(), *_strides(b, b_axes), x.data_ptr(),
        *_strides(x, x_axes), n, k, nb, cuda_lib.stream_ptr(a.device),
    )
    return x


def solve_spd_lanes_cuda(a_t: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """K8 on the card in the lanes layout: (n, n, N) systems valid at
    [c, r ≥ c], (n, k, N) right-hand sides, any strides → (n, k, N), one
    warp per system in one launch."""
    n, nb = a_t.shape[0], a_t.shape[-1]
    if a_t.ndim != 3 or a_t.shape[1] != n or not 1 <= n <= MAX_N or nb < 1:
        raise ValueError(f"solve_spd: need (n, n, N) systems with n <= {MAX_N}, got {tuple(a_t.shape)}")
    if b_t.ndim != 3 or b_t.shape[0] != n or b_t.shape[2] != nb or b_t.shape[1] < 1:
        raise ValueError(f"solve_spd: need (n={n}, k, N={nb}) right-hand sides, got {tuple(b_t.shape)}")
    out_t = torch.empty((n, b_t.shape[1], nb), dtype=a_t.dtype, device=a_t.device)
    return _solve_spd_launch(a_t, (2, 1, 0), b_t, (2, 0, 1), out_t, (2, 0, 1))


def solve_spd_cuda(spd: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """K8 on the card in the bank-first layout: (N, n, n) systems, lower
    triangle read, (N, n, k) right-hand sides, any strides → (N, n, k), one
    warp per system in one launch."""
    nb, n = spd.shape[0], spd.shape[-1]
    if spd.ndim != 3 or spd.shape[1] != n or not 1 <= n <= MAX_N or nb < 1:
        raise ValueError(f"solve_spd_cuda: need (N, n, n) systems with n <= {MAX_N}, got {tuple(spd.shape)}")
    if rhs.ndim != 3 or rhs.shape[0] != nb or rhs.shape[1] != n or rhs.shape[2] < 1:
        raise ValueError(f"solve_spd_cuda: need (N={nb}, n={n}, k) right-hand sides, got {tuple(rhs.shape)}")
    x = torch.empty((nb, n, rhs.shape[2]), dtype=spd.dtype, device=spd.device)
    return _solve_spd_launch(spd, (0, 1, 2), rhs, (0, 1, 2), x, (0, 1, 2))


def _solve_spd_rule(call, in_dims, spd, rhs):
    """vmap rule of K8's op: each operand's vmap dim (size V) to the front,
    an unbatched operand expanded to V (a view for a bank of one), then one
    call on (V·N, n, n), (V·N, n, k), unfolded to (V, N, n, k)."""
    size = spd.shape[in_dims[0]] if in_dims[0] is not None else rhs.shape[in_dims[1]]

    def fold(t, d):
        t = t[None].expand(size, *t.shape) if d is None else t.movedim(d, 0)
        return t.reshape(-1, *t.shape[2:])

    out = call(fold(spd, in_dims[0]), fold(rhs, in_dims[1]))
    return out.reshape(size, -1, *out.shape[1:]), 0


_SOLVE_SPD = cuda_lib.kernel_op(
    "solve_spd", "(Tensor spd, Tensor rhs) -> Tensor",
    lambda spd, rhs: solve_spd_cuda(spd, rhs), lambda spd, rhs: solve_spd_plain(spd, rhs),
    lambda spd, rhs: _new(spd, spd.shape[0], spd.shape[-1], rhs.shape[-1]), vmap=_solve_spd_rule,
)


def solve_spd_banked(spd: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """A⁻¹B for SPD ``spd`` (N, n, n) or (n, n) and ``rhs`` (N, n, k) or
    (n, k): n ≤ ``UNROLL_LIMIT`` by the unrolled substitution of
    ``linalg_small`` on any device; larger n by K8 for a CUDA tensor (any
    bank, float32 or float64) and by :func:`solve_spd_plain` for a CPU
    tensor. Under ``torch.func.vmap`` the op's rule folds the vmapped axes
    into K8's bank, so a vmapped call on one system is one launch."""
    single = spd.ndim == 2
    if single:
        spd, rhs = spd[None], rhs[None]
    if spd.shape[-1] <= UNROLL_LIMIT:
        out = solve_spd(spd, rhs)
    else:
        cuda_lib.route("solve_spd_banked", spd)
        out = _SOLVE_SPD(spd, rhs)
    return out[0] if single else out


def solve_spd_fast(spd: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """A⁻¹B for one SPD system (n, n), (n, k) or for stacks (..., n, n),
    (..., n, k) whose leading axes broadcast: they flatten into one bank for
    :func:`solve_spd_banked` (K8 on the card past ``UNROLL_LIMIT``), which
    is what JAX's vmap rule of ``solve_spd_fast`` does."""
    if spd.ndim == 2 and rhs.ndim == 2:
        return solve_spd_banked(spd, rhs)
    lead = torch.broadcast_shapes(spd.shape[:-2], rhs.shape[:-2])
    n, k = spd.shape[-1], rhs.shape[-1]
    a = spd.expand(*lead, n, n).reshape(-1, n, n)
    b = rhs.expand(*lead, n, k).reshape(-1, n, k)
    return solve_spd_banked(a, b).reshape(*lead, n, k)


# ---------------------------------------------------------------------------
# K12: the banked lower Cholesky
# ---------------------------------------------------------------------------


def cholesky_lanes_plain(a_t: torch.Tensor) -> torch.Tensor:
    """K12's function in its own layout, in PyTorch: (n, n, N) matrices valid
    at [c, r ≥ c] → (n, n, N) factors in (col, row, N) order."""
    return cholesky_plain(_mirror_half(a_t).permute(2, 1, 0)).permute(2, 1, 0).contiguous()


def cholesky_lanes_cuda(a_t: torch.Tensor) -> torch.Tensor:
    """K12 on the card in the lanes layout: (n, n, N) SPD matrices in (col,
    row, N) order, lower half read, any strides → (n, n, N) lower factors L =
    D·chol(D⁻¹AD⁻¹) with explicit zeros above the diagonal, one warp per
    matrix; a matrix whose factorization fails comes back all NaN."""
    n, nb = a_t.shape[0], a_t.shape[-1]
    if a_t.ndim != 3 or a_t.shape[1] != n or not 1 <= n <= MAX_N or nb < 1:
        raise ValueError(f"cholesky: need (n, n, N) with n <= {MAX_N}, got {tuple(a_t.shape)}")
    out_t = torch.empty((n, n, nb), dtype=a_t.dtype, device=a_t.device)
    return _factor_launch("cholesky", a_t, (2, 1, 0), out_t, (2, 1, 0))


def cholesky_cuda(cov: torch.Tensor) -> torch.Tensor:
    """K12 on the card in the bank-first layout: (N, n, n), lower triangle
    read, any strides → (N, n, n), one warp per matrix, read and written in
    place (no layout copy)."""
    nb, n = cov.shape[0], cov.shape[-1]
    if cov.ndim != 3 or cov.shape[1] != n or not 1 <= n <= MAX_N or nb < 1:
        raise ValueError(f"cholesky_cuda: need (N, n, n) with n <= {MAX_N}, got {tuple(cov.shape)}")
    out = torch.empty((nb, n, n), dtype=cov.dtype, device=cov.device)
    return _factor_launch("cholesky", cov, (0, 1, 2), out, (0, 1, 2))


_CHOLESKY = cuda_lib.kernel_op(
    "cholesky", "(Tensor cov) -> Tensor",
    lambda cov: cholesky_cuda(cov), lambda cov: cholesky_plain(cov),
    lambda cov: _new(cov, *cov.shape), vmap=_bank_first_rule,
)


def cholesky_banked(cov: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of SPD ``cov`` (N, n, n) or (n, n), lower triangle
    read: n ≤ ``UNROLL_LIMIT`` unrolled on any device; larger n diagonally
    equilibrated (L = D·chol(D⁻¹PD⁻¹), which keeps the 53-DOF covariance's
    1e-11 … 10 variances within float32) by K12 for a CUDA tensor (float32
    or float64, any bank, n ≤ ``MAX_N``) and by :func:`cholesky_plain` for a
    CPU tensor. A failed factorization gives NaN."""
    single = cov.ndim == 2
    if single:
        cov = cov[None]
    if cov.shape[-1] <= UNROLL_LIMIT:
        out = cholesky_unrolled(cov)
    else:
        cuda_lib.route("cholesky_banked", cov)
        out = _CHOLESKY(cov)
    return out[0] if single else out


def cholesky_fast(cov: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of one (n, n) or of any (..., n, n) stack: the leading
    axes flatten into one bank for :func:`cholesky_banked`. Under
    ``torch.func.vmap`` the op's rule folds the vmapped axes into that bank
    too (one K12 launch on the card), as JAX's vmap rule of
    ``cholesky_fast`` does."""
    n = cov.shape[-1]
    if cov.ndim == 2:
        return cholesky_banked(cov)
    return cholesky_banked(cov.reshape(-1, n, n)).reshape(cov.shape)

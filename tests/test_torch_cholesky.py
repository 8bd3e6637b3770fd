"""The port's Cholesky API (``ops/kernels.cholesky_banked`` /
``cholesky_fast``, the plain route of K12) against the JAX package's
``cholesky_banked`` / ``cholesky_fast`` (float64, CPU), mirroring
tests/test_kernels.py: the unrolled sizes n ∈ {2, 4, 6} and the
equilibrated sizes n ∈ {9, 53, 55}, banks that are not a multiple of 128,
covariances with a wide variance spread, and a (2, 3, 53, 53) stack through
``cholesky_fast``. One comparison with the JAX kernel itself in interpret
mode at a bank of 5 × 53. Also the plain FMA probe of K13 against a NumPy
chain, and the refusal of a device the port has no path for.

Tolerances: both packages equilibrate the same way and factor with LAPACK,
so they agree to rounding: rtol 1e-10 with an atol of 1e-12 of each
matrix's largest factor entry (the spread cases hold entries down to
~1e-7 of it). The interpret-mode kernel runs its own right-looking loop:
the same tolerance. The probe's float32 chain sits within 2e-7 of float64
relative to its largest output (128 rounded steps); the limit is 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from slam_uwv_kalman_filters_tpu.ops import kernels as jk
from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
from slam_uwv_kalman_filters_tpu_torch.ops import kernels as tk
from slam_uwv_kalman_filters_tpu_torch.tools import roofline

RNG_SEED = 31


def random_spd_batch(rng, nb, n, cond_spread=True):
    """tests/test_kernels.py's SPD batch: aaᵀ + n·I, every third matrix
    scaled by D = diag(10^U(-6, 1)) (the PoseUKF covariance's spread)."""
    out = np.zeros((nb, n, n))
    for i in range(nb):
        a = rng.normal(size=(n, n))
        out[i] = a @ a.T + n * np.eye(n)
        if cond_spread and i % 3 == 0:
            d = np.diag(10.0 ** rng.uniform(-6, 1, n))
            out[i] = d @ out[i] @ d
    return out


def _close(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    scale = np.abs(ref).reshape(-1, *ref.shape[-2:]).max(axis=(-2, -1)).reshape(ref.shape[:-2] + (1, 1))
    assert np.all(np.abs(port - ref) <= 1e-10 * np.abs(ref) + 1e-12 * scale), np.abs(port - ref).max()


@pytest.mark.parametrize("n,nb,spread", [(2, 3, False), (4, 3, False), (6, 3, False), (9, 7, True), (53, 5, True),
                                         (55, 130, True)])
def test_cholesky_banked_plain_route_matches_jax(n, nb, spread):
    covs = random_spd_batch(np.random.default_rng(RNG_SEED + n), nb, n, spread)
    ref = np.asarray(jk.cholesky_banked(covs))
    out = tk.cholesky_banked(torch.from_numpy(covs))
    _close(out, ref)
    assert np.all(np.triu(out.numpy(), 1) == 0.0)  # explicit zeros above the diagonal
    one = tk.cholesky_banked(torch.from_numpy(covs[1]))
    _close(one, np.asarray(jk.cholesky_banked(covs[1])))


def test_cholesky_reads_the_lower_triangle_only():
    covs = random_spd_batch(np.random.default_rng(RNG_SEED), 4, 53)
    spoiled = covs.copy()
    spoiled[:, np.triu_indices(53, 1)[0], np.triu_indices(53, 1)[1]] = np.nan
    _close(tk.cholesky_banked(torch.from_numpy(spoiled)), np.asarray(jk.cholesky_banked(covs)))


def test_cholesky_fast_flattens_leading_axes_like_the_jax_vmap_rule():
    rng = np.random.default_rng(RNG_SEED + 1)
    covs = random_spd_batch(rng, 6, 53).reshape(2, 3, 53, 53)
    ref = np.asarray(jax.jit(jax.vmap(jax.vmap(jk.cholesky_fast)))(covs))
    out = tk.cholesky_fast(torch.from_numpy(covs))
    assert out.shape == (2, 3, 53, 53)
    _close(out, ref)
    _close(tk.cholesky_fast(torch.from_numpy(covs[0, 0])), np.asarray(jk.cholesky_fast(covs[0, 0])))


def test_cholesky_plain_matches_the_jax_kernel_in_interpret_mode():
    covs = random_spd_batch(np.random.default_rng(RNG_SEED + 2), 5, 53)
    ref = np.asarray(jk.cholesky_banked(covs, force_pallas=True))
    _close(tk.cholesky_plain(torch.from_numpy(covs)), ref)
    lanes = tk.cholesky_lanes_plain(torch.from_numpy(covs).permute(2, 1, 0).contiguous())
    _close(lanes.permute(2, 1, 0), ref)


def test_failed_factorization_is_nan_and_other_devices_raise():
    cuda_lib.reset_launch_counts()
    covs = random_spd_batch(np.random.default_rng(RNG_SEED + 3), 3, 53)
    covs[1, 7, 7] = -1.0  # not SPD
    out = tk.cholesky_banked(torch.from_numpy(covs))
    assert torch.isnan(out[1]).all() and torch.isfinite(out[[0, 2]]).all()
    with pytest.raises(ValueError, match="no path for device meta"):
        tk.cholesky_banked(torch.empty(3, 53, 53, dtype=torch.float64, device="meta"))
    assert all(k.launches == 0 for k in cuda_lib.KERNELS.values())


def test_plain_fma_probe_matches_a_numpy_chain():
    rng = np.random.default_rng(RNG_SEED + 4)
    a = rng.uniform(0.75, 1.25, 4096).astype(np.float32)
    b = rng.uniform(0.9, 1.0, 4096).astype(np.float32)
    out = roofline.fma_probe_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    chains = [a64, a64 + 1.0, a64 + 2.0, a64 + 3.0]
    for _ in range(roofline.CHAIN // 4):
        chains = [c * b64 + a64 for c in chains]
    ref = sum(chains) * 1e-3
    assert out.dtype == np.float32
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()

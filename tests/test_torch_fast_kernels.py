"""``ops.kernels.sigma_deltas_fast`` and ``solve_spd_fast`` of the port (the
plain routes of K1 and K8 on the CPU) against the JAX package's, float64:
one matrix, and stacks of leading axes where JAX maps the one-matrix form
with ``vmap`` (a (2, 3) stack of 53×53 covariances; solves with a shared
system or shared right-hand sides broadcast over the stack).

Tolerance: both equilibrate and factor with LAPACK-grade Cholesky, rtol
1e-10 with an atol of 1e-12 of the largest entry.
"""

import jax
import numpy as np
import pytest
import torch

from slam_uwv_kalman_filters_tpu.ops import kernels as jk
from slam_uwv_kalman_filters_tpu_torch.ops import kernels as tk

from torch_parity import random_spd


def close(out, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-10, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("n", [6, 53])
def test_sigma_deltas_fast(n):
    rng = np.random.default_rng(n)
    cov = random_spd(rng, n, 6, 10.0 ** rng.uniform(-3, 1, n)).reshape(2, 3, n, n)
    close(tk.sigma_deltas_fast(torch.as_tensor(cov[0, 0])), jk.sigma_deltas_fast(cov[0, 0]))
    out = tk.sigma_deltas_fast(torch.as_tensor(cov))
    assert out.shape == (2, 3, 2 * n + 1, n)
    close(out, jax.vmap(jax.vmap(jk.sigma_deltas_fast))(cov))


@pytest.mark.parametrize("n", [5, 53])
def test_solve_spd_fast(n):
    rng = np.random.default_rng(n + 1)
    a = random_spd(rng, n, 6).reshape(2, 3, n, n)
    b = rng.normal(size=(2, 3, n, 4))
    close(tk.solve_spd_fast(torch.as_tensor(a[0, 0]), torch.as_tensor(b[0, 0])), jk.solve_spd_fast(a[0, 0], b[0, 0]))
    close(tk.solve_spd_fast(torch.as_tensor(a), torch.as_tensor(b)), jax.vmap(jax.vmap(jk.solve_spd_fast))(a, b))
    # a shared system against a stack of right-hand sides, and the converse
    shared = tk.solve_spd_fast(torch.as_tensor(a[0, 0]), torch.as_tensor(b))
    close(shared, jax.vmap(jax.vmap(jk.solve_spd_fast, (None, 0)), (None, 0))(a[0, 0], b))
    close(tk.solve_spd_fast(torch.as_tensor(a), torch.as_tensor(b[0, 0])),
          jax.vmap(jax.vmap(jk.solve_spd_fast, (0, None)), (0, None))(a, b[0, 0]))

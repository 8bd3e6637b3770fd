"""The port's filter metrics (``utils/metrics.py``) against the JAX
package's (float64, CPU): NIS and NEES over a bank (JAX maps them with
``vmap``, the port broadcasts over leading axes), the covariance condition
number, ATE, heading error and the per-update record; and
``covariance_condition`` on an indefinite, a collapsed and a NaN matrix in
float32 and float64, which ``torch.linalg.eigvalsh`` alone would refuse.

Tolerances: the same LAPACK-grade solves and eigenvalues on the same
inputs, rtol 1e-12 in float64 (condition numbers of moderately conditioned
matrices: a condition number is as exact as its smallest eigenvalue);
float32 condition numbers of an indefinite matrix (condition 1e3) rtol
1e-4. One deliberate difference: a matrix with a NaN entry gives NaN in the
port and inf in JAX (whose ``den > 0`` select is False for NaN eigenvalues,
so a non-finite covariance reads as a collapsed one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_uwv_kalman_filters_tpu.ops.ukf import UpdateInfo as JUpdateInfo
from slam_uwv_kalman_filters_tpu.utils import metrics as jm
from slam_uwv_kalman_filters_tpu_torch.ops.ukf import UpdateInfo
from slam_uwv_kalman_filters_tpu_torch.utils import metrics as tm

from torch_parity import random_spd

F64 = dict(rtol=1e-12, atol=0.0)


def t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def close(out, ref, **tol):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **(tol or F64))


def test_public_names_match_the_jax_module():
    assert tm.__all__ == jm.__all__


@pytest.mark.parametrize("m", [1, 3, 53])
def test_nis_and_nees_over_a_bank(m):
    rng = np.random.default_rng(m)
    cov = random_spd(rng, m, 7, 10.0 ** rng.uniform(-3, 1, m))
    v = rng.normal(size=(7, m))
    close(tm.nis(t(v), t(cov)), jax.vmap(jm.nis)(v, cov))
    close(tm.nees(t(v), t(cov)), jax.vmap(jm.nees)(v, cov))
    # one instance, and a (2, 7) stack of leading axes
    close(tm.nees(t(v[0]), t(cov[0])), jm.nees(v[0], cov[0]))
    stack = tm.nees(t(v).expand(2, 7, m), t(cov).expand(2, 7, m, m))
    assert stack.shape == (2, 7)
    close(stack[1], jax.vmap(jm.nees)(v, cov))


def test_nees_of_a_singular_covariance_is_nan_not_an_error():
    out = tm.nees(t(np.ones((2, 3))), t(np.stack([np.eye(3), np.zeros((3, 3))])))
    assert np.isfinite(out[0].item()) and np.isnan(out[1].item())


def test_covariance_condition_ate_heading_against_jax():
    rng = np.random.default_rng(5)
    # a condition number is only as exact as the smallest eigenvalue (eps ×
    # condition): moderately conditioned matrices, so 1e-12 holds
    cov = random_spd(rng, 53, 6)
    close(tm.covariance_condition(t(cov)), jax.vmap(jm.covariance_condition)(cov))
    est, truth = rng.normal(size=(50, 3)), rng.normal(size=(50, 3))
    close(tm.ate_rmse(t(est), t(truth)), jm.ate_rmse(est, truth))
    q1, q2 = rng.normal(size=(40, 4)), rng.normal(size=(40, 4))
    q1 /= np.linalg.norm(q1, axis=-1, keepdims=True)
    q2 /= np.linalg.norm(q2, axis=-1, keepdims=True)
    close(tm.heading_error(t(q1), t(q2)), jm.heading_error(q1, q2), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("with_condition", [False, True])
def test_step_metrics_record(with_condition):
    rng = np.random.default_rng(11)
    cov = random_spd(rng, 6, 4)
    m2, acc, nu = rng.uniform(0, 5, 4), np.array([True, False, True, True]), rng.normal(size=(4, 3))
    ref = jax.vmap(lambda i, c: jm.step_metrics(i, c, with_condition=with_condition))(
        JUpdateInfo(jnp.asarray(m2), jnp.asarray(acc), jnp.asarray(nu)), jnp.asarray(cov))
    out = tm.step_metrics(UpdateInfo(t(m2), torch.as_tensor(acc), t(nu)), t(cov), with_condition=with_condition)
    assert out._fields == ref._fields
    close(out.nis, ref.nis)
    np.testing.assert_array_equal(out.accepted.numpy(), np.asarray(ref.accepted))
    close(out.cov_trace, ref.cov_trace)
    close(out.cov_condition, ref.cov_condition)


def _cases():
    rng = np.random.default_rng(2)
    rot, _ = np.linalg.qr(rng.normal(size=(4, 4)))
    indefinite = rot @ np.diag([1.0, -1000.0, 2.0, 0.5]) @ rot.T
    collapsed = np.diag([1.0, 0.0, 3.0, 2.0])
    bad = np.eye(4)
    bad[1, 2] = bad[2, 1] = np.nan
    return {"indefinite": indefinite, "collapsed": collapsed, "nan": bad}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["indefinite", "collapsed", "nan"])
def test_covariance_condition_edge_cases(case, dtype):
    a = _cases()[case]
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    ref = np.asarray(jm.covariance_condition(jnp.asarray(a, np_dtype)))
    bank = np.stack([np.eye(4), a])  # a healthy neighbour must stay exact
    out = tm.covariance_condition(t(bank, dtype))
    assert out.dtype == dtype
    assert out[0].item() == 1.0
    if case == "indefinite":
        assert ref > 999.0
        np.testing.assert_allclose(out[1].item(), ref, rtol=1e-4 if dtype == torch.float32 else 1e-12)
    elif case == "collapsed":
        assert np.isinf(ref) and np.isinf(out[1].item()) and out[1].item() > 0
    else:
        # JAX's select maps the NaN eigenvalues to its collapsed answer, inf;
        # the port keeps "not finite" apart from "collapsed"
        assert np.isinf(ref) and np.isnan(out[1].item())

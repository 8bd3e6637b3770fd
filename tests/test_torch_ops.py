"""Parity of the PyTorch port's ops layer with the JAX package (float64, CPU).

Tolerances: rtol 1e-9 / atol 1e-12 for single closed-form operations (the
two packages round the same float64 arithmetic in different orders); the
iterative mean is held to atol 1e-10, because each side stops its tolerance
loop (1e-12) after its own last correction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_uwv_kalman_filters_tpu.ops import dynamics as jdyn
from slam_uwv_kalman_filters_tpu.ops import geodesy as jgeo
from slam_uwv_kalman_filters_tpu.ops import kernels as jkernels
from slam_uwv_kalman_filters_tpu.ops import linalg_small as jlin
from slam_uwv_kalman_filters_tpu.ops import manifolds as jmf
from slam_uwv_kalman_filters_tpu.models.pose_ukf import POSE_MANIFOLD as J_MANIFOLD, PoseState as JPoseState
from slam_uwv_kalman_filters_tpu.utils import validation as jval
from slam_uwv_kalman_filters_tpu_torch.ops import dynamics as tdyn
from slam_uwv_kalman_filters_tpu_torch.ops import geodesy as tgeo
from slam_uwv_kalman_filters_tpu_torch.ops import kernels as tkernels
from slam_uwv_kalman_filters_tpu_torch.ops import linalg_small as tlin
from slam_uwv_kalman_filters_tpu_torch.ops import manifolds as tmf
from slam_uwv_kalman_filters_tpu_torch.models.pose_ukf import POSE_MANIFOLD as T_MANIFOLD
from slam_uwv_kalman_filters_tpu_torch.utils import validation as tval

from torch_parity import mission_init, pt, random_bank, random_spd

RTOL, ATOL = 1e-9, 1e-12


def _t(a):
    return torch.as_tensor(np.array(a, np.float64))


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_quaternion_ops_match_jax():
    rng = np.random.default_rng(0)
    q, p = _quats(rng, 16), _quats(rng, 16)
    v = rng.normal(size=(16, 3))
    # include tiny rotations to exercise the Taylor branches
    v[:3] *= 1e-9
    for port, ref in (
        (tmf.quat_mul(_t(q), _t(p)), jax.vmap(jmf.quat_mul)(q, p)),
        (tmf.quat_rotate(_t(q), _t(v)), jax.vmap(jmf.quat_rotate)(q, v)),
        (tmf.quat_rotate_inv(_t(q), _t(v)), jax.vmap(jmf.quat_rotate_inv)(q, v)),
        (tmf.quat_exp(_t(v)), jax.vmap(jmf.quat_exp)(v)),
        (tmf.quat_log(_t(q)), jax.vmap(jmf.quat_log)(q)),
        (tmf.quat_to_matrix(_t(q)), jax.vmap(jmf.quat_to_matrix)(q)),
        (tmf.so3_boxplus(_t(q), _t(v), 0.5), jax.vmap(lambda a, b: jmf.so3_boxplus(a, b, 0.5))(q, v)),
        (tmf.so3_boxminus(_t(q), _t(p)), jax.vmap(jmf.so3_boxminus)(q, p)),
    ):
        _close(port, ref)
    m = jax.vmap(jmf.quat_to_matrix)(q)
    _close(tmf.quat_from_matrix(_t(m)), jax.vmap(jmf.quat_from_matrix)(m))


def test_product_manifold_boxplus_boxminus_mean_match_jax():
    rng = np.random.default_rng(1)
    state, _ = mission_init()
    bank = random_bank(rng, state, 4)
    delta = rng.normal(0.0, 0.2, (4, 53))
    jmu = jax.tree.map(jnp.asarray, bank.mu)
    tmu = pt(bank.mu)
    j_plus = jax.vmap(J_MANIFOLD.boxplus)(jmu, delta)
    t_plus = T_MANIFOLD.boxplus(tmu, _t(delta))
    for name in JPoseState._fields:
        _close(getattr(t_plus, name), getattr(j_plus, name))
    _close(T_MANIFOLD.boxminus(t_plus, tmu), jax.vmap(J_MANIFOLD.boxminus)(j_plus, jmu))
    # mean over a leading point axis (7 points × bank 4 in the port, vmapped in JAX)
    pts_delta = rng.normal(0.0, 0.3, (7, 4, 53))
    t_pts = T_MANIFOLD.boxplus(tmu, _t(pts_delta))
    j_pts = jax.vmap(lambda m, d: jax.vmap(lambda dd: J_MANIFOLD.boxplus(m, dd))(d))(jmu, np.swapaxes(pts_delta, 0, 1))
    j_mean = jax.vmap(J_MANIFOLD.mean)(j_pts)
    t_mean = T_MANIFOLD.mean(t_pts)
    for name in JPoseState._fields:
        # iterative mean: each side stops its own 1e-12 tolerance loop
        _close(getattr(t_mean, name), getattr(j_mean, name), atol=1e-10)


@pytest.mark.parametrize("m", [1, 2, 3, 6])
def test_linalg_small_matches_jax(m):
    rng = np.random.default_rng(2 + m)
    s = random_spd(rng, m, 5, np.exp(rng.normal(size=m)))
    b = rng.normal(size=(5, m, 4))
    _close(tlin.cholesky_unrolled(_t(s)), jax.vmap(jlin.cholesky_unrolled)(s))
    _close(tlin.solve_spd(_t(s), _t(b)), jax.vmap(jlin.solve_spd)(s, b))


def test_geodesy_matches_jax():
    rng = np.random.default_rng(3)
    lat = rng.uniform(-1.4, 1.4, 8)
    alt = rng.uniform(-100, 100, 8)
    _close(tgeo.wgs84_gravity(_t(lat), _t(alt)), jgeo.wgs84_gravity(lat, alt))
    _close(tgeo.earth_rotation_nav(_t(lat)), jax.vmap(jgeo.earth_rotation_nav)(lat))
    tp, jp = tgeo.make_projection(0.822, 0.153, device="cpu"), jgeo.make_projection(0.822, 0.153)
    for a, b in zip(tp, jp):
        _close(a, b)
    x, y = rng.normal(0, 500, 8), rng.normal(0, 500, 8)
    for a, b in zip(tgeo.nav_to_world(tp, _t(x), _t(y)), jgeo.nav_to_world(jp, x, y)):
        _close(a, b)
    la, lo = jgeo.nav_to_world(jp, x, y)
    for a, b in zip(tgeo.world_to_nav(tp, _t(la), _t(lo)), jgeo.world_to_nav(jp, la, lo)):
        _close(a, b, atol=1e-9)  # metres from radians × ~6.4e6 m


def test_calc_efforts_matches_jax():
    rng = np.random.default_rng(4)
    spd = lambda: random_spd(rng, 6, 1, rng.uniform(5, 15, 6))[0]
    params = jdyn.UWVParameters(
        inertia_matrix=spd(), damping_linear=spd(), damping_quadratic=spd(),
        weight=np.float64(980.7), buoyancy=np.float64(990.0),
        cog=rng.normal(0, 0.05, 3), cob=rng.normal(0, 0.05, 3),
    )
    acc, vel, q = rng.normal(size=(8, 6)), rng.normal(size=(8, 6)), _quats(rng, 8)
    ref = jax.vmap(lambda a, v, o: jdyn.calc_efforts(params, a, v, o))(acc, vel, q)
    tparams = tdyn.UWVParameters(*[_t(x) for x in params])
    _close(tdyn.calc_efforts(tparams, _t(acc), _t(vel), _t(q)), ref)


def test_sigma_deltas_plain_matches_jax_at_pose_size():
    rng = np.random.default_rng(5)
    state, _ = mission_init()
    cov = random_bank(rng, state, 4).cov  # n = 53, variances 1e-11 … 1e1
    ref = jkernels.sigma_deltas_banked(cov)
    out = tkernels.sigma_deltas_plain(_t(cov))
    assert out.shape == (4, 107, 53)
    _close(out, ref)
    # the public entry takes the plain route for a CPU tensor
    _close(tkernels.sigma_deltas_banked(_t(cov)), ref)


@pytest.mark.parametrize(
    "mu, cov, banked",
    [
        ([1.0, 2.0], np.eye(2), None),
        ([1.0, np.nan], np.eye(2), None),
        ([1.0, 2.0], [1.0, -1.0], None),
        ([[1.0, 2.0], [3.0, np.inf]], np.eye(2), None),
        ([[1.0, 2.0], [3.0, 4.0]], [[1.0, 1.0], [-1.0, 1.0]], None),
        ([[1.0, 2.0], [3.0, 4.0]], np.stack([np.eye(2), -np.eye(2)]), None),
        ([1.0, 2.0, 3.0], [1.0, -1.0, 1.0], True),
    ],
)
def test_measurement_valid_matches_jax(mu, cov, banked):
    ref = np.asarray(jval.measurement_valid(np.asarray(mu), np.asarray(cov), banked=banked))
    out = tval.measurement_valid(_t(mu), _t(cov), banked=banked)
    np.testing.assert_array_equal(out.numpy(), ref)
    if ref.ndim == 0:
        raises = not bool(ref)
        try:
            tval.check_measurement(_t(mu), _t(cov))
        except ValueError:
            assert raises
        else:
            assert not raises


def test_bank_select_and_mask_match_jax():
    from slam_uwv_kalman_filters_tpu.parallel import bank as jbank
    from slam_uwv_kalman_filters_tpu_torch.parallel import bank as tbank

    rng = np.random.default_rng(6)
    state, _ = mission_init()
    a, b = random_bank(rng, state, 4), random_bank(rng, state, 4)
    mask = np.array([True, False, True, False])
    ref = jbank.select_where(mask, jax.tree.map(jnp.asarray, a), jax.tree.map(jnp.asarray, b))
    out = tbank.select_where(torch.tensor(mask), pt(a), pt(b))
    for x, y in zip(jax.tree.leaves(ref), jax.tree.leaves(tuple(out))):
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
    info = (np.array([1.0, np.nan, 3.0, 4.0]), mask, np.ones((4, 2)), np.float64(7.0))
    ref = jbank.mask_rows(np.array([True, False, False, True]), info)
    out = tbank.mask_rows(torch.tensor([True, False, False, True]), tuple(_t(x) if x.dtype != bool else torch.tensor(x) for x in map(np.asarray, info)))
    for x, y in zip(ref, out):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    rep = tbank.replicate(pt(state), 3)
    assert rep.cov.shape == (3, 53, 53) and torch.equal(rep.cov[2], pt(state).cov)

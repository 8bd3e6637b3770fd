"""Parity of the PyTorch port's generic PoseUKF with the JAX package
(float64, CPU): construction from one config, prediction and the seven
mission-tick measurement updates, solo and bank (bank 3).

Tolerances: the constructors are closed-form (rtol 1e-9 / atol 1e-12). A
prediction or update runs a 53-DOF Cholesky and sums 107 sigma points in
another order than JAX, and the prediction's quaternion mean is a 1e-12
tolerance loop on both sides, so states are held to rtol 1e-8 / atol 1e-10
(the covariance's smallest variances are ~1e-11, its largest ~10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_uwv_kalman_filters_tpu.models import pose_ukf as jpukf
from slam_uwv_kalman_filters_tpu.ops import dynamics as jdyn
from slam_uwv_kalman_filters_tpu.ops import ukf as jukf
from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config as jcfg
from slam_uwv_kalman_filters_tpu_torch.models import pose_ukf as tpukf
from slam_uwv_kalman_filters_tpu_torch.ops import dynamics as tdyn
from slam_uwv_kalman_filters_tpu_torch.utils.config import default_pose_ukf_config as tcfg

from torch_parity import DT, assert_tree_close, jx, mission_init, pt, random_bank

STEP = dict(rtol=1e-8, atol=1e-10)


def test_init_from_pose_matches_jax():
    args = dict(
        imu_in_nwu_pos=[1.0, -2.0, -3.0],
        imu_in_nwu_pos_cov=np.diag([0.01, 0.02, 0.03]),
        imu_in_nwu_rot=[np.cos(0.2), 0.0, 0.0, np.sin(0.2)],
        imu_in_nwu_rot_cov=np.eye(3) * 1e-4,
        imu_delta_t=0.01,
        imu_in_body_rot=[np.cos(0.05), np.sin(0.05), 0.0, 0.0],
        imu_in_body_trans=[0.1, 0.0, -0.2],
    )
    jstate, jparams = jpukf.init_from_pose(
        config=jcfg(), model_parameters=jdyn.default_uwv_parameters(),
        **{k: jnp.asarray(v) for k, v in args.items() if k != "imu_delta_t"}, imu_delta_t=0.01,
    )
    tstate, tparams = tpukf.init_from_pose(
        config=tcfg(), model_parameters=tdyn.default_uwv_parameters(device="cpu"),
        **{k: torch.tensor(np.asarray(v, np.float64)) for k, v in args.items() if k != "imu_delta_t"},
        imu_delta_t=0.01, device="cpu",
    )
    assert_tree_close(tstate, jstate, rtol=1e-9, atol=1e-12)
    assert_tree_close(tparams, jparams, rtol=1e-9, atol=1e-12)


@pytest.fixture(scope="module")
def bank():
    state, params = mission_init()
    return random_bank(np.random.default_rng(10), state, 3), params


def test_predict_solo_and_bank_match_jax(bank):
    bstate, params = bank
    one = jax.tree.map(lambda a: a[0], bstate)
    ref = jax.jit(lambda s, p: jpukf.predict(s, p, DT))(jx(one), jx(params))
    assert_tree_close(tpukf.predict(pt(one), pt(params), DT), ref, **STEP, what="solo")
    ref_b = jax.jit(lambda s, p: jpukf.predict_bank(s, p, DT))(jx(bstate), jx(params))
    assert_tree_close(tpukf.predict_bank(pt(bstate), pt(params), DT), ref_b, **STEP, what="bank")


# name → (measurement std, extra args for (module, bstate-or-state, params))
UPDATES = {
    "velocity": (0.03, lambda mod, s, p: ()),
    "acceleration": (0.006, lambda mod, s, p: ()),
    "z_position": (0.1, lambda mod, s, p: ()),
    "xy_position": (0.7, lambda mod, s, p: (jukf.D2P95,)),
    "pressure": (50.0, lambda mod, s, p: ()),
    "water_velocity": (0.03, lambda mod, s, p: (0.3,)),
    "body_efforts": (1.0, None),
}


def _truth(name, bstate, params):
    """The JAX measurement model at each instance's mean, (B, m)."""
    mu = jx(bstate.mu)
    p = jx(params)
    if name == "pressure":
        h = jpukf._h_pressure(p.atmospheric_pressure, jnp.zeros(3))
    elif name == "water_velocity":
        h = jpukf._h_water_velocity(0.3)
    elif name == "body_efforts":
        rr = jpukf.get_rotation_rate_bank(jx(bstate), p)
        return np.asarray(jax.vmap(lambda m, r: jpukf._efforts_measurement(m, p, r))(mu, rr))
    else:
        h = getattr(jpukf, f"_h_{name}")
    return np.asarray(jax.vmap(h)(mu))


@pytest.mark.parametrize("form", ["solo", "bank"])
@pytest.mark.parametrize("name", list(UPDATES))
def test_update_matches_jax(bank, name, form):
    bstate, params = bank
    std, extra = UPDATES[name]
    rng = np.random.default_rng(20 + list(UPDATES).index(name))
    truth = _truth(name, bstate, params)
    z = truth + rng.normal(0.0, std, truth.shape)
    if name in ("xy_position", "water_velocity"):
        z[0] += 20.0  # instance 0 fails the χ²-95 gate
    meas_cov = np.eye(truth.shape[1]) * std**2
    if form == "solo":
        bstate = jax.tree.map(lambda a: a[1:2], bstate)
        z = z[1:2]
    if form == "solo" and name == "body_efforts":
        j_fn = lambda s, p, zz, r: jpukf.update_body_efforts(s, p, zz, r)
        t_fn = tpukf.update_body_efforts
    elif form == "solo":
        j_fn = lambda s, p, zz, r: getattr(jpukf, f"update_{name}")(s, p, zz, r, *extra(jpukf, s, p))
        t_fn = lambda s, p, zz, r: getattr(tpukf, f"update_{name}")(s, p, zz, r, *extra(tpukf, s, p))
    elif name == "body_efforts":
        j_fn = lambda s, p, zz, r: jpukf.update_body_efforts_bank(
            s, p, zz, r, jpukf.get_rotation_rate_bank(s, p))
        t_fn = lambda s, p, zz, r: tpukf.update_body_efforts_bank(
            s, p, zz, r, tpukf.get_rotation_rate_bank(s, p))
    else:
        j_fn = lambda s, p, zz, r: getattr(jpukf, f"update_{name}_bank")(s, p, zz, r, *extra(jpukf, s, p))
        t_fn = lambda s, p, zz, r: getattr(tpukf, f"update_{name}_bank")(s, p, zz, r, *extra(tpukf, s, p))

    if form == "solo":
        one = jax.tree.map(lambda a: a[0], bstate)
        ref_state, ref_info = jax.jit(j_fn)(jx(one), jx(params), jnp.asarray(z[0]), jnp.asarray(meas_cov))
        out_state, out_info = t_fn(pt(one), pt(params), torch.tensor(z[0]), torch.tensor(meas_cov))
    else:
        ref_state, ref_info = jax.jit(j_fn)(jx(bstate), jx(params), jnp.asarray(z), jnp.asarray(meas_cov))
        out_state, out_info = t_fn(pt(bstate), pt(params), torch.tensor(z), torch.tensor(meas_cov))
    assert_tree_close(out_state, ref_state, **STEP, what=f"{name}/{form}")
    np.testing.assert_array_equal(out_info.accepted.numpy(), np.asarray(ref_info.accepted))
    np.testing.assert_allclose(
        out_info.mahalanobis2.numpy(), np.asarray(ref_info.mahalanobis2), rtol=1e-8, atol=1e-10
    )
    if form == "bank" and name in ("xy_position", "water_velocity"):
        assert not bool(out_info.accepted[0]) and bool(out_info.accepted[1:].all())


def test_constructors_build_on_the_card_by_default():
    """``device=None`` means the card; without one a constructor raises and
    names ``device="cpu"``, which builds on the CPU."""
    from slam_uwv_kalman_filters_tpu_torch.models import fleet_setup
    from slam_uwv_kalman_filters_tpu_torch.ops import geodesy as tgeo

    args = (torch.zeros(3, dtype=torch.float64), torch.eye(3, dtype=torch.float64),
            torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64), torch.eye(3, dtype=torch.float64), tcfg())
    ctors = (
        lambda **kw: tpukf.init_from_pose(*args, tdyn.default_uwv_parameters(**kw), **kw),
        lambda **kw: tdyn.default_uwv_parameters(**kw),
        lambda **kw: tgeo.make_projection(0.8, 0.1, **kw),
        lambda **kw: fleet_setup.build_fleet_setup(minutes=0.01, rate=10.0, **kw),
    )
    for ctor in ctors:
        assert ctor(device="cpu") is not None
        if torch.cuda.is_available():
            assert ctor() is not None
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                ctor()


@pytest.fixture(scope="module")
def banked():
    from torch_parity import banked_params

    state, params = mission_init()
    rng = np.random.default_rng(12)
    return random_bank(rng, state, 3), banked_params(rng, params, 3)


@pytest.mark.parametrize("name", ["predict", "pressure", "body_efforts"])
def test_generic_bank_with_banked_params_matches_jax(banked, name):
    """The generic bank path with a banked (Monte-Carlo) parameter set: each
    banked leaf broadcasts along the bank, JAX vmaps over it."""
    bstate, bparams = banked
    tb, tp = pt(bstate), pt(bparams)
    if name == "predict":
        ref = jax.jit(lambda s, p: jpukf.predict_bank(s, p, DT))(jx(bstate), jx(bparams))
        assert_tree_close(tpukf.predict_bank(tb, tp, DT), ref, **STEP)
        return
    rng = np.random.default_rng(13)
    m = {"pressure": 1, "body_efforts": 6}[name]
    z = rng.normal(0.0, 1.0, (3, m)) + (101325.0 if name == "pressure" else 0.0)
    r = np.eye(m) * (2500.0 if name == "pressure" else 1.0)
    j_one = getattr(jpukf, f"update_{name}")
    ref, ref_info = jax.jit(jax.vmap(lambda s, p, zz: j_one(s, p, zz, jnp.asarray(r))))(
        jx(bstate), jx(bparams), jnp.asarray(z))
    if name == "pressure":
        out, info = tpukf.update_pressure_bank(tb, tp, torch.tensor(z), torch.tensor(r))
    else:
        out, info = tpukf.update_body_efforts_bank(tb, tp, torch.tensor(z), torch.tensor(r),
                                                   tpukf.get_rotation_rate_bank(tb, tp))
    assert_tree_close(out, ref, **STEP)
    np.testing.assert_allclose(info.mahalanobis2.numpy(), np.asarray(ref_info.mahalanobis2), **STEP)


@pytest.mark.parametrize("form", ["solo", "bank"])
def test_geographic_and_delayed_position_match_jax(bank, form):
    """GPS fixes (projection, lever arm, χ²-95 gate) and the active
    delayed-position update, solo and bank."""
    from slam_uwv_kalman_filters_tpu.ops import geodesy as jgeo

    bstate, params = bank
    rng = np.random.default_rng(14)
    xy = np.asarray(bstate.mu.position[:, :2]) + rng.normal(0.0, 0.5, (3, 2))
    xy[0] += 30.0  # instance 0 fails the GPS gate
    lat, lon = (np.asarray(a) for a in jgeo.nav_to_world(jx(params.projection), jnp.asarray(xy[:, 0]),
                                                         jnp.asarray(xy[:, 1])))
    lever = np.array([0.2, -0.1, 0.4])
    gps_cov, dcov = np.eye(2) * 0.25, np.eye(2) * 0.04
    dz, dpos = rng.normal(0.0, 0.2, (3, 2)), rng.normal(0.0, 0.2, (3, 2))
    p = jx(params)
    if form == "solo":
        one = jax.tree.map(lambda a: a[1], bstate)
        j_gps = jax.jit(lambda s: jpukf.update_geographic_position(s, p, lat[1], lon[1], gps_cov, jnp.asarray(lever)))
        j_del = jax.jit(lambda s: jpukf.update_delayed_position(s, p, dz[1], dcov, dpos[1]))
        ref_g, ref_d = j_gps(jx(one)), j_del(jx(one))
        t = pt(one)
        out_g = tpukf.update_geographic_position(t, pt(params), torch.tensor(lat[1]), torch.tensor(lon[1]),
                                                 torch.tensor(gps_cov), torch.tensor(lever))
        out_d = tpukf.update_delayed_position(t, pt(params), torch.tensor(dz[1]), torch.tensor(dcov),
                                              torch.tensor(dpos[1]))
    else:
        j_gps = jax.jit(lambda s: jpukf.update_geographic_position_bank(s, p, lat, lon, gps_cov, jnp.asarray(lever)))
        j_del = jax.jit(lambda s: jpukf.update_delayed_position_bank(s, p, dz, dcov, dpos))
        ref_g, ref_d = j_gps(jx(bstate)), j_del(jx(bstate))
        t = pt(bstate)
        out_g = tpukf.update_geographic_position_bank(t, pt(params), torch.tensor(lat), torch.tensor(lon),
                                                      torch.tensor(gps_cov), torch.tensor(lever))
        out_d = tpukf.update_delayed_position_bank(t, pt(params), torch.tensor(dz), torch.tensor(dcov),
                                                   torch.tensor(dpos))
        assert not bool(out_g[1].accepted[0])
    for (out_s, out_i), (ref_s, ref_i), what in ((out_g, ref_g, "gps"), (out_d, ref_d, "delayed")):
        assert_tree_close(out_s, ref_s, **STEP, what=what)
        np.testing.assert_array_equal(out_i.accepted.numpy(), np.asarray(ref_i.accepted))

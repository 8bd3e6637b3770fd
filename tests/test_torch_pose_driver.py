"""Parity of the PyTorch port's mission driver with the JAX package (float64,
CPU): the packed schedule, the solo replay, the bank replay with shared and
fully banked parameters, and the lanes replay (the plain versions of K1, K2
in both modes, K3 and K4, which CPU tensors take) against the JAX generic
bank replay, over a few ticks and over 1000.

Tolerances: one tick rtol 1e-8 / atol 1e-10 (test_torch_pose_fused.py); a
trajectory rtol 1e-6 / atol 1e-9, because the two sides round ~10 53-column
factorizations per tick in their own order. The JAX reference is its
generic path (``use_fused=False``), never a Pallas kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_uwv_kalman_filters_tpu.models import pose_driver as jdrv
from slam_uwv_kalman_filters_tpu.models import pose_ukf as jpukf
from slam_uwv_kalman_filters_tpu.ops import dynamics as jdyn
from slam_uwv_kalman_filters_tpu.ops import geodesy as jgeo
from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config
from slam_uwv_kalman_filters_tpu_torch.models import pose_driver as tdrv
from slam_uwv_kalman_filters_tpu_torch.utils.convert import to_numpy

from torch_parity import assert_tree_close, banked_params, jx, np_tree, pt

TRAJ = dict(rtol=1e-6, atol=1e-9)
DT = 0.05


def _mission(n):
    """(bank state, shared params) of the JAX package's banked lanes test:
    dt 0.05, moved positions and velocities."""
    rng = np.random.default_rng(31)
    state, params = jpukf.init_from_pose(
        imu_in_nwu_pos=jnp.zeros(3), imu_in_nwu_pos_cov=jnp.eye(3) * 0.04,
        imu_in_nwu_rot=jnp.array([1.0, 0, 0, 0]), imu_in_nwu_rot_cov=jnp.eye(3) * 1e-4,
        config=default_pose_ukf_config(), model_parameters=jdyn.default_uwv_parameters(),
        imu_delta_t=DT,
    )
    state, params = np_tree(state), np_tree(params)
    bstate = jax.tree.map(lambda a: np.broadcast_to(a, (n, *np.shape(a))).copy(), state)
    bstate = bstate._replace(mu=bstate.mu._replace(
        position=rng.normal(scale=0.5, size=(n, 3)), velocity=rng.normal(scale=0.2, size=(n, 3))))
    return state, bstate, params


def _streams(rng, T, n, params, *, event_streams=True):
    """Keyword streams of ``make_inputs`` for a (T·n)-row schedule: every
    always-on stream with random validity, plus depth, GPS and delayed XY."""
    flat = lambda a: np.reshape(np.asarray(a), (T * n, *np.shape(a)[2:]))
    kw = dict(
        acc=flat(rng.normal(scale=0.05, size=(T, n, 3)) + np.array([0, 0, 9.81])),
        acc_cov=np.eye(3) * 4e-5,
        dvl=flat(rng.normal(scale=0.2, size=(T, n, 3))), dvl_cov=np.eye(3) * 1e-3,
        dvl_valid=flat(rng.random((T, n)) < 0.7),
        pressure=np.full((T * n, 1), 101325.0), pressure_cov=np.eye(1) * 2500.0,
        pressure_valid=flat(rng.random((T, n)) < 0.5),
        xy=flat(rng.normal(scale=0.3, size=(T, n, 2))), xy_cov=np.eye(2) * 0.01,
        xy_valid=flat(rng.random((T, n)) < 0.5),
        adcp=flat(rng.normal(scale=0.05, size=(T, n, 2))), adcp_cov=np.eye(2) * 1e-3,
        adcp_cell_weighting=flat(rng.random((T, n))), adcp_valid=flat(rng.random((T, n)) < 0.5),
        efforts=flat(rng.normal(scale=0.5, size=(T, n, 6))), efforts_cov=np.eye(6),
        efforts_valid=flat(rng.random((T, n)) < 0.6),
    )
    if event_streams:
        proj = jx(params.projection)
        xy = rng.normal(scale=0.5, size=(T, n, 2))
        lat, lon = jgeo.nav_to_world(proj, jnp.asarray(xy[..., 0]), jnp.asarray(xy[..., 1]))
        kw.update(
            z=flat(rng.normal(scale=0.1, size=(T, n, 1))), z_cov=np.eye(1) * 1e-3,
            z_valid=flat(rng.random((T, n)) < 0.5),
            gps=flat(np.stack([np.asarray(lat), np.asarray(lon)], -1)), gps_cov=np.eye(2) * 0.04,
            gps_valid=flat(rng.random((T, n)) < 0.5),
            delayed_xy=flat(rng.normal(scale=0.2, size=(T, n, 2))), delayed_xy_cov=np.eye(2) * 0.01,
            delayed_position=flat(rng.normal(scale=0.2, size=(T, n, 2))),
            delayed_valid=flat(rng.random((T, n)) < 0.5),
        )
    return kw


def _inputs(T, n, kw, rotation_rate):
    """The same schedule from both packages' ``make_inputs``, reshaped to
    (T, n, …): (JAX, port)."""
    j = jdrv.make_inputs(T * n, DT, rotation_rate, **kw, dtype=jnp.float64)
    t = tdrv.make_inputs(T * n, DT, torch.tensor(rotation_rate),
                         **{k: torch.tensor(np.asarray(v)) for k, v in kw.items()}, device="cpu")
    shape = lambda x: x.reshape(T, n, *x.shape[1:])
    return (jax.tree.map(shape, j),
            tdrv.PoseInputs(*(None if x is None else shape(x) for x in t)))


def _close_outputs(out, ref, tol):
    ref = np_tree(ref)
    out = to_numpy(out)
    for name in ("position", "orientation", "velocity", "cov_trace", "dvl_nis"):
        np.testing.assert_allclose(getattr(out, name), getattr(ref, name), **tol, err_msg=name)
    np.testing.assert_array_equal(out.adcp_accepted, ref.adcp_accepted)
    if ref.gps_accepted is not None:
        np.testing.assert_array_equal(out.gps_accepted, ref.gps_accepted)


def test_make_inputs_matches_jax():
    rng = np.random.default_rng(1)
    _, _, params = _mission(1)
    kw = _streams(rng, 5, 2, params)
    kw["marker_features"] = rng.normal(size=(4, 2))
    kw["marker_feature_covs"] = np.tile(np.eye(2), (4, 1, 1))
    rot = rng.normal(scale=0.01, size=(10, 3))
    j = jdrv.make_inputs(10, DT, rot, **kw, dtype=jnp.float64)
    t = tdrv.make_inputs(10, DT, torch.tensor(rot), **{k: torch.tensor(np.asarray(v)) for k, v in kw.items()},
                         device="cpu")
    for name, a, b in zip(jdrv.PoseInputs._fields, t, j):
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    # omitted always-on streams are all-invalid dummies, event streams None
    lean = tdrv.make_inputs(3, DT, torch.zeros(3), acc=torch.zeros(3), device="cpu")
    assert not bool(lean.dvl_valid.any()) and bool(lean.acc_valid.all()) and lean.gps is None


def test_run_trajectory_matches_jax():
    """One filter, every stream but markers, 4 ticks."""
    state, _, params = _mission(1)
    rng = np.random.default_rng(2)
    jin, tin = _inputs(4, 1, _streams(rng, 4, 1, params), rng.normal(scale=0.02, size=(4, 3)))
    jin = jax.tree.map(lambda x: x[:, 0], jin)
    tin = tdrv.PoseInputs(*(None if x is None else x[:, 0] for x in tin))
    consts = jdrv.PoseStepConstants(gps_in_body=jnp.array([0.1, -0.2, 0.3]))
    ref_s, ref_o = jdrv.run_trajectory(jx(state), jx(params), jin, consts)
    out_s, out_o = tdrv.run_trajectory(pt(state), pt(params), tin,
                                       tdrv.PoseStepConstants(gps_in_body=torch.tensor([0.1, -0.2, 0.3])))
    assert_tree_close(out_s, ref_s, **TRAJ, what="state")
    _close_outputs(out_o, ref_o, TRAJ)


@pytest.mark.parametrize("param_form", ["shared", "banked"])
def test_run_trajectory_bank_matches_jax(param_form):
    """Bank 3, 4 ticks, every stream but markers; the banked draw moves every
    per-instance parameter (Monte-Carlo sweep)."""
    n, T = 3, 4
    _, bstate, params = _mission(n)
    rng = np.random.default_rng(3)
    if param_form == "banked":
        params = banked_params(rng, params, n)
    jin, tin = _inputs(T, n, _streams(rng, T, n, params), rng.normal(scale=0.02, size=(T * n, 3)))
    ref_s, ref_o = jdrv.run_trajectory_bank(jx(bstate), jx(params), jin, use_fused=False)
    out_s, out_o = tdrv.run_trajectory_bank(pt(bstate), pt(params), tin)
    assert_tree_close(out_s, ref_s, **TRAJ, what=param_form)
    _close_outputs(out_o, ref_o, TRAJ)


def test_run_trajectory_bank_lanes_matches_jax_banked():
    """The lanes replay (K2 full mode, K3 with per-instance p_atm, K1 + K4
    for the banked vehicle model, GPS and delayed XY in K3), plain versions,
    against the JAX generic bank replay; bank 3, 4 ticks."""
    n, T = 3, 4
    _, bstate, params = _mission(n)
    rng = np.random.default_rng(4)
    params = banked_params(rng, params, n)
    jin, tin = _inputs(T, n, _streams(rng, T, n, params), rng.normal(scale=0.02, size=(T * n, 3)))
    ref_s, ref_o = jdrv.run_trajectory_bank(jx(bstate), jx(params), jin, use_fused=False)
    out_s, out_o = tdrv.run_trajectory_bank_lanes(pt(bstate), pt(params), tin)
    assert_tree_close(out_s, ref_s, **TRAJ, what="lanes")
    _close_outputs(out_o, ref_o, TRAJ)


def test_banked_lanes_trajectory_1000_ticks_matches_jax():
    """1000 ticks at bank 2 with banked parameters (single-step parity once
    hid a NaN at tick 40-700): acceleration every tick, DVL 5 Hz, pressure
    with per-instance p_atm 2 Hz, body efforts with a per-instance vehicle
    model 10 Hz, on a stationary vehicle with noisy sensors."""
    from torch_parity import mission_init

    n, T = 2, 1000
    state, params = mission_init()
    rng = np.random.default_rng(5)
    params = banked_params(rng, params, n)
    bstate = jax.tree.map(lambda a: np.broadcast_to(a, (n, *np.shape(a))).copy(), state)
    bstate = bstate._replace(mu=bstate.mu._replace(position=rng.normal(scale=0.1, size=(n, 3))))
    g = float(jgeo.wgs84_gravity(0.822, 0.0))
    k = np.arange(T)
    every = lambda period: np.repeat((k % period == period - 1)[:, None], n, 1).reshape(-1)
    kw = dict(
        acc=(np.array([0.0, 0.0, g]) + rng.normal(scale=2e-3, size=(T, n, 3))).reshape(-1, 3),
        acc_cov=np.eye(3) * 4e-5,
        dvl=rng.normal(scale=1e-2, size=(T * n, 3)), dvl_cov=np.eye(3) * 1e-3, dvl_valid=every(20),
        pressure=101325.0 + rng.normal(scale=50.0, size=(T * n, 1)), pressure_cov=np.eye(1) * 2500.0,
        pressure_valid=every(50),
        efforts=rng.normal(scale=0.5, size=(T * n, 6)), efforts_cov=np.eye(6), efforts_valid=every(10),
    )
    jin, tin = _inputs(T, n, kw, np.tile([0.0, 0.0, 0.01], (T * n, 1)))
    jin = jin._replace(xy=None, xy_cov=None, xy_valid=None, adcp=None, adcp_cov=None,
                       adcp_cell_weighting=None, adcp_valid=None)
    tin = tin._replace(xy=None, xy_cov=None, xy_valid=None, adcp=None, adcp_cov=None,
                       adcp_cell_weighting=None, adcp_valid=None)
    ref_s, ref_o = jdrv.run_trajectory_bank(jx(bstate), jx(params), jin, use_fused=False)
    out_s, out_o = tdrv.run_trajectory_bank_lanes(pt(bstate), pt(params), tin)
    assert torch.isfinite(out_s.cov).all()
    assert_tree_close(out_s, ref_s, **TRAJ, what="1000 ticks")
    _close_outputs(out_o, ref_o, TRAJ)


def test_marker_schedule_raises():
    """A schedule with marker detections and no ``MarkerSetup`` in the
    constants raises, as in JAX (the marker update itself is held to JAX in
    tests/test_torch_pose_markers.py)."""
    state, bstate, params = _mission(2)
    tin = tdrv.make_inputs(3, DT, torch.zeros(3), acc=torch.zeros(3),
                           marker_features=torch.zeros(4, 2), marker_feature_covs=torch.eye(2).expand(4, 2, 2),
                           device="cpu")
    with pytest.raises(ValueError, match="MarkerSetup"):
        tdrv.run_trajectory(pt(state), pt(params), tin)
    bank_in = tdrv.PoseInputs(*(None if x is None else x[:, None].expand(3, 2, *x.shape[1:]) for x in tin))
    for run in (tdrv.run_trajectory_bank, tdrv.run_trajectory_bank_lanes):
        with pytest.raises(ValueError, match="MarkerSetup"):
            run(pt(bstate), pt(params), bank_in, tdrv.PoseStepConstants(gps_in_body=torch.zeros(3)))


def test_banked_lanes_replay_rejects_a_varying_interval():
    _, bstate, params = _mission(2)
    params = banked_params(np.random.default_rng(6), params, 2)
    tin = tdrv.make_inputs(3, DT, torch.zeros(3), acc=torch.zeros(3), device="cpu")
    tin = tdrv.PoseInputs(*(None if x is None else x[:, None].expand(3, 2, *x.shape[1:]) for x in tin))
    tin = tin._replace(dt=tin.dt * torch.tensor([1.0, 2.0, 1.0], dtype=torch.float64)[:, None])
    with pytest.raises(ValueError, match="constant prediction interval"):
        tdrv.run_trajectory_bank_lanes(pt(bstate), pt(params), tin)

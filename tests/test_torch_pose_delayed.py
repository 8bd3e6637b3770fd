"""Parity of the port's PoseUKF delayed-state surface and class with the JAX
package (float64, CPU): the 55-DOF augmented delayed fix, the buffered
out-of-sequence fix (found and beyond the buffer's horizon), the buffer
push and the external-pose reset, solo and bank; the velocity-only body
efforts (``only_affect_velocity``); the ``PoseUKF`` class through one
schedule of every ``integrate_*`` method against JAX's class; and a
1000-tick trajectory through the port's class with buffered delayed fixes
(``tools/host_paths.class_schedule``: the mission rates, a fix 1 s late every
2 s) against the JAX package's pure functions, each jitted once.

Tolerances: one update runs a 53- or 55-column Cholesky and sums 107 or 111
sigma points in another order than JAX, so a step is held to rtol 1e-8 /
atol 1e-10 (the covariance's smallest variances are ~1e-11, its largest
~10); the class schedule, ~20 chained steps, the same; the trajectory to
rtol 1e-6 / atol 1e-9, as the port's other 1000-tick parity tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_uwv_kalman_filters_tpu.models import pose_ukf as jpukf
from slam_uwv_kalman_filters_tpu.ops import dynamics as jdyn
from slam_uwv_kalman_filters_tpu.parallel import bank as jbank
from slam_uwv_kalman_filters_tpu.utils import delayed_states as jds
from slam_uwv_kalman_filters_tpu.utils.config import CameraConfiguration as JCam
from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config as jcfg
from slam_uwv_kalman_filters_tpu_torch.models import pose_ukf as tpukf
from slam_uwv_kalman_filters_tpu_torch.ops import dynamics as tdyn
from slam_uwv_kalman_filters_tpu_torch.parallel import bank as tbank
from slam_uwv_kalman_filters_tpu_torch.tools import host_paths
from slam_uwv_kalman_filters_tpu_torch.utils import delayed_states as tds
from slam_uwv_kalman_filters_tpu_torch.utils.config import CameraConfiguration as TCam
from slam_uwv_kalman_filters_tpu_torch.utils.config import default_pose_ukf_config as tcfg

from torch_parity import DT, assert_tree_close, jx, mission_init, pt, random_bank

STEP = dict(rtol=1e-8, atol=1e-10)
TRAJ = dict(rtol=1e-6, atol=1e-9)
NB = 3


@pytest.fixture(scope="module")
def bank():
    state, params = mission_init()
    return random_bank(np.random.default_rng(40), state, NB, spread=0.3), params


def _one(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


def _info_close(port, ref, what):
    np.testing.assert_allclose(port.mahalanobis2.numpy(), np.asarray(ref.mahalanobis2), rtol=1e-8, atol=1e-10,
                               err_msg=what)
    np.testing.assert_array_equal(port.accepted.numpy(), np.asarray(ref.accepted), err_msg=what)
    np.testing.assert_allclose(port.innovation.numpy(), np.asarray(ref.innovation), rtol=1e-8, atol=1e-12,
                               err_msg=what)


def test_delayed_manifold_has_55_dof():
    assert tpukf.POSE_DELAYED_MANIFOLD.dof == jpukf.POSE_DELAYED_MANIFOLD.dof == 55
    assert tpukf.PoseStateWithDelayedPosition._fields == jpukf.PoseStateWithDelayedPosition._fields


def test_augmented_delayed_fix_solo_and_bank_match_jax(bank):
    bstate, params = bank
    rng = np.random.default_rng(41)
    z, dpos = rng.normal(scale=0.5, size=(NB, 2)), rng.normal(scale=0.3, size=(NB, 2))
    r, dcov = np.eye(2) * 0.1, np.array([[0.05, 0.01], [0.01, 0.04]])
    ref, rinfo = jax.jit(jpukf.update_delayed_position_with_augmentation)(
        jx(_one(bstate)), jx(params), z[0], r, dpos[0], dcov)
    out, info = tpukf.update_delayed_position_with_augmentation(pt(_one(bstate)), pt(params), z[0], r, dpos[0], dcov)
    assert_tree_close(out, ref, **STEP, what="solo")
    _info_close(info, rinfo, "solo")
    ref_b, rinfo_b = jax.jit(jpukf.update_delayed_position_with_augmentation_bank)(
        jx(bstate), jx(params), z, r, dpos, dcov)
    out_b, info_b = tpukf.update_delayed_position_with_augmentation_bank(pt(bstate), pt(params), z, r, dpos, dcov)
    assert_tree_close(out_b, ref_b, **STEP, what="bank")
    _info_close(info_b, rinfo_b, "bank")


def _walk(bstate, jpush, tpush, jbuf, tbuf, ticks=5):
    """Push ``ticks`` states 0.5 s apart, each moved 0.1·(k+1) m."""
    ts, walk = 0, bstate
    for k in range(ticks):
        ts += int(jds.from_seconds(0.5))
        walk = walk._replace(mu=walk.mu._replace(position=walk.mu.position + 0.1 * (k + 1)))
        jbuf = jpush(jbuf, jx(walk), ts)
        tbuf = tpush(tbuf, pt(walk), ts)
    return walk, ts, jbuf, tbuf


def test_push_and_buffered_fix_solo_match_jax(bank):
    bstate, params = bank
    one = _one(bstate)
    walk, ts, jbuf, tbuf = _walk(one, jpukf.push_delayed_state, tpukf.push_delayed_state,
                                 jds.make_buffer(16, 2, 5.0), tds.make_buffer(16, 2, 5.0, device="cpu"))
    assert_tree_close(tbuf, jbuf, rtol=0, atol=0, what="buffer")
    z, r = np.array([0.3, -0.2]), np.eye(2) * 0.1
    fix = jax.jit(jpukf.update_delayed_position_buffered)
    for delay, expect in ((1.1, True), (100.0, False)):
        ref, rinfo, rfound = fix(jx(walk), jx(params), jbuf, ts, z, r, delay)
        out, info, found = tpukf.update_delayed_position_buffered(pt(walk), pt(params), tbuf, ts, z, r, delay)
        assert bool(found) == bool(rfound) == expect
        assert_tree_close(out, ref, **STEP, what=f"delay {delay}")
        _info_close(info, rinfo, f"delay {delay}")
    assert not bool(info.accepted) and float(info.mahalanobis2) == 0.0  # neutralized beyond the horizon


def test_push_and_buffered_fix_bank_match_jax(bank):
    bstate, params = bank
    walk, ts, jbuf, tbuf = _walk(bstate, jpukf.push_delayed_state_bank, tpukf.push_delayed_state_bank,
                                 jbank.replicate(jds.make_buffer(16, 2, 5.0), NB),
                                 tbank.replicate(tds.make_buffer(16, 2, 5.0, device="cpu"), NB))
    assert_tree_close(tbuf, jbuf, rtol=0, atol=0, what="bank buffer")
    rng = np.random.default_rng(42)
    z, r = rng.normal(scale=0.2, size=(NB, 2)), np.eye(2) * 0.1
    delays = np.array([0.6, 1.6, 100.0])  # per-vehicle latency; the last beyond the horizon
    ref, rinfo, rfound = jax.jit(jpukf.update_delayed_position_buffered_bank)(
        jx(walk), jx(params), jbuf, ts, z, r, delays)
    out, info, found = tpukf.update_delayed_position_buffered_bank(
        pt(walk), pt(params), tbuf, ts, z, r, torch.from_numpy(delays))
    np.testing.assert_array_equal(found.numpy(), np.asarray(rfound))
    assert found.tolist() == [True, True, False]
    assert_tree_close(out, ref, **STEP, what="bank")
    _info_close(info, rinfo, "bank")
    np.testing.assert_array_equal(out.cov[2].numpy(), walk.cov[2])


def test_reset_with_external_pose_matches_jax(bank):
    bstate, _ = bank
    pos, q = np.array([1.0, -2.0, -3.0]), np.array([np.cos(0.3), 0.0, 0.0, np.sin(0.3)])
    for state in (_one(bstate), bstate):
        ref = jpukf.reset_with_external_pose(jx(state), jnp.asarray(pos), jnp.asarray(q))
        assert_tree_close(tpukf.reset_with_external_pose(pt(state), pos, q), ref, rtol=0, atol=0)


def test_velocity_only_body_efforts_match_jax(bank):
    bstate, params = bank
    one = _one(bstate)
    z, r = np.array([10.0, -5.0, 2.0, 0.5, -0.3, 0.1]), np.eye(6) * 4.0
    for mode in (True, False):
        ref, rinfo = jax.jit(jpukf.update_body_efforts, static_argnums=4)(jx(one), jx(params), z, r, mode)
        out, info = tpukf.update_body_efforts(pt(one), pt(params), z, r, only_affect_velocity=mode)
        assert_tree_close(out, ref, **STEP, what=f"only_affect_velocity={mode}")
        _info_close(info, rinfo, f"only_affect_velocity={mode}")


def _classes():
    args = dict(imu_in_nwu_pos=[1.0, 2.0, -3.0], imu_in_nwu_pos_cov=np.eye(3) * 0.01,
                imu_in_nwu_rot=[np.cos(0.1), 0.0, 0.0, np.sin(0.1)], imu_in_nwu_rot_cov=np.eye(3) * 1e-4)
    ref = jpukf.PoseUKF(**{k: jnp.asarray(v, jnp.float64) for k, v in args.items()}, config=jcfg(),
                        model_parameters=jdyn.default_uwv_parameters(), imu_delta_t=DT,
                        imu_in_body_trans=jnp.array([0.1, 0.0, -0.2]))
    ours = tpukf.PoseUKF(**args, config=tcfg(), model_parameters=tdyn.default_uwv_parameters(device="cpu"),
                         imu_delta_t=DT, imu_in_body_trans=[0.1, 0.0, -0.2], device="cpu")
    return ours, ref


def test_class_through_every_integrate_method_matches_jax():
    ours, ref = _classes()
    assert ours.sigma.device.type == "cpu" and ours.sigma.dtype == torch.float64
    cfg = jcfg()
    lat0, lon0 = cfg.location.latitude, cfg.location.longitude
    corners = np.array([[0.15, 0.15, 0.0], [-0.15, 0.15, 0.0], [-0.15, -0.15, 0.0], [0.15, -0.15, 0.0]])
    cam = JCam()
    steps = [
        ("setup_delayed_state_buffer", (2.0, 32)),
        ("integrate_rotation_rate", ([0.0, 0.0, 0.01],)),
        ("prediction_step", (DT,)),
        ("integrate_acceleration", ([0.0, 0.0, 9.81], np.eye(3) * 4e-5)),
        ("prediction_step", (DT,)),
        ("integrate_velocity", ([0.3, 0.01, 0.0], np.eye(3) * 1e-3)),
        ("integrate_z_position", ([-3.05], np.eye(1) * 0.01)),
        ("integrate_xy_position", ([1.02, 1.98], np.eye(2) * 0.5)),
        ("integrate_delayed_position", ([1.0, 2.01], np.eye(2) * 0.5, [0.99, 2.0])),
        ("integrate_pressure", ([101325.0 + 3.0 * 9.81 * 1027.0], np.eye(1) * 2500.0, [0.0, 0.1, -0.2])),
        ("integrate_geographic_position", (lat0 + 1e-7, lon0 - 1e-7, np.eye(2) * 4.0, [0.5, 0.0, -1.5])),
        ("integrate_body_efforts", ([5.0, 0.0, 0.0, 0.0, 0.0, 0.1], np.eye(6), False)),
        ("integrate_body_efforts", ([5.0, 0.0, 0.0, 0.0, 0.0, 0.1], np.eye(6), True)),
        ("integrate_water_velocity", ([0.05, -0.02], np.eye(2) * 1e-3, 0.3)),
        ("prediction_step", (DT,)),
        ("integrate_delayed_measurement", ([1.0, 2.0], np.eye(2) * 0.2, 0.01)),
        ("integrate_delayed_measurement", ([1.0, 2.0], np.eye(2) * 0.2, 50.0)),
        ("integrate_delayed_position_with_augmentation", ([1.01, 2.0], np.eye(2) * 0.1, [1.0, 2.0],
                                                          np.eye(2) * 0.02)),
        ("integrate_visual_features", (np.array([[300.0, 220.0], [340.0, 222.0], [338.0, 260.0], [301.0, 258.0]]),
                                       np.tile(np.eye(2) * 0.25, (4, 1, 1)), corners, [7.0, 2.0, -3.0],
                                       [0.5, -0.5, 0.5, -0.5], np.eye(6) * 1e-6, None, [0.0, 0.0, 0.0],
                                       [0.5, -0.5, 0.5, -0.5])),
        ("set_process_noise_from_config", (jcfg(), 0.02)),
        ("prediction_step", (0.02,)),
        ("set_process_noise_covariance", (np.diag(np.linspace(1e-8, 1e-4, 53)),)),
        ("prediction_step", (DT,)),
        ("reset_filter_with_external_pose", ([1.1, 2.1, -3.0], [1.0, 0.0, 0.0, 0.0])),
    ]
    for name, args in steps:
        if name == "integrate_visual_features":
            jargs, targs = args[:6] + (cam,) + args[7:], args[:6] + (TCam(**vars(cam)),) + args[7:]
        elif name == "set_process_noise_from_config":
            jargs, targs = args, (tcfg(),) + args[1:]
        else:
            jargs = targs = args
        want = getattr(ref, name)(*[jnp.asarray(a) if isinstance(a, (list, np.ndarray)) else a for a in jargs])
        got = getattr(ours, name)(*targs)
        assert_tree_close(ours.state, ref.state, **STEP, what=name)
        if name == "integrate_delayed_measurement":
            assert got == want
        elif isinstance(got, tuple):
            assert_tree_close(got, want, **STEP, what=f"{name} info")
    assert_tree_close(ours.mu, ref.mu, **STEP)
    np.testing.assert_allclose(ours.sigma.numpy(), np.asarray(ref.sigma), **STEP)
    np.testing.assert_allclose(ours.get_rotation_rate().numpy(), np.asarray(ref.get_rotation_rate()), **STEP)
    assert ours.params.process_noise.dtype == torch.float64
    again = tpukf.PoseUKF.from_state(ours.mu, ours.sigma, ours.params, dtype=torch.float32, device="cpu")
    assert again.sigma.dtype == torch.float32 and again.params.process_noise.dtype == torch.float32
    with pytest.raises(ValueError, match="NaN"):
        ours.integrate_velocity([np.nan, 0.0, 0.0], np.eye(3))


def run_class(ours, sched, ticks, each):
    """``tools/host_paths.class_run``'s ticks on ``ours``: rotation rate and
    prediction every tick (the delayed buffer of 2 s set up first), then the
    tick's measurements; ``each(k, found)`` after every delayed fix."""
    ours.setup_delayed_state_buffer(2.0, 256)
    r = {"acc": np.eye(3) * 4e-5, "dvl": np.eye(3) * 1e-3, "press": np.eye(1) * 2500.0, "eff": np.eye(6),
         "fix": np.eye(2) * 0.09}
    for k in range(ticks):
        ours.integrate_rotation_rate([0.0, 0.0, 0.01])
        ours.prediction_step(DT)
        ours.integrate_acceleration(sched["acc"][k], r["acc"])
        if k % 20 == 19:
            ours.integrate_velocity(sched["dvl"][k], r["dvl"])
        if k % 50 == 49:
            ours.integrate_pressure(sched["press"][k], r["press"])
        if k % 10 == 9:
            ours.integrate_body_efforts(sched["eff"][k], r["eff"], only_affect_velocity=True)
        if k % 200 == 199:
            each(k, ours.integrate_delayed_measurement(sched["fix"][k], r["fix"], 1.0))


def test_class_trajectory_1000_ticks_with_buffered_fixes_matches_jitted_jax():
    ticks = 1000
    ours, ref = _classes()
    q0 = jnp.asarray([np.cos(0.1), 0.0, 0.0, np.sin(0.1)])
    efforts = jdyn.calc_efforts(jdyn.default_uwv_parameters(), jnp.zeros(6),
                                jnp.asarray([0.3, 0.0, 0.0, 0.0, 0.0, 0.01]), q0)
    sched = host_paths.class_schedule(ticks, float(ref.state.mu.gravity[0]), np.asarray(efforts))

    @jax.jit
    def predict_push(s, p, buf, ts):
        s = jpukf.predict(s._replace(rotation_rate=jnp.array([0.0, 0.0, 0.01])), p, DT)
        return s, jpukf.push_delayed_state(buf, s, ts)

    acc = jax.jit(lambda s, p, z: jpukf.update_acceleration(s, p, z, jnp.eye(3) * 4e-5)[0])
    vel = jax.jit(lambda s, p, z: jpukf.update_velocity(s, p, z, jnp.eye(3) * 1e-3)[0])
    press = jax.jit(lambda s, p, z: jpukf.update_pressure(s, p, z, jnp.eye(1) * 2500.0)[0])
    eff = jax.jit(lambda s, p, z: jpukf.update_body_efforts(s, p, z, jnp.eye(6), True)[0])
    fix = jax.jit(lambda s, p, b, ts, z: jpukf.update_delayed_position_buffered(s, p, b, ts, z, jnp.eye(2) * 0.09,
                                                                                1.0))
    s, p = ref.state, ref.params
    buf, ts = jds.make_buffer(256, 2, 2.0), 0
    ref_found, checkpoints = [], {}
    for k in range(ticks):
        ts += int(jds.from_seconds(DT))
        s, buf = predict_push(s, p, buf, ts)
        s = acc(s, p, sched["acc"][k])
        if k % 20 == 19:
            s = vel(s, p, sched["dvl"][k])
        if k % 50 == 49:
            s = press(s, p, sched["press"][k])
        if k % 10 == 9:
            s = eff(s, p, sched["eff"][k])
        if k % 200 == 199:
            s, info, found = fix(s, p, buf, ts, sched["fix"][k])
            ref_found.append((bool(found), bool(info.accepted)))
            checkpoints[k] = s

    got_found = []

    def each(k, found):
        got_found.append(found)
        assert_tree_close(ours.state, checkpoints[k], **TRAJ, what=f"tick {k}")

    run_class(ours, sched, ticks, each)
    assert got_found == [f for f, _ in ref_found] == [True] * 5
    assert sum(a for _, a in ref_found) >= 3  # most fixes pass the χ²-95 gate
    assert_tree_close(ours.state, s, **TRAJ, what="1000 ticks")

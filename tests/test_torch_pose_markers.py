"""Parity of the PyTorch port's PoseUKF visual-marker path with the JAX
package at float64 on the CPU: the bearing model, the 59-DOF augmented update
(solo and bank, with its refusals), the lanes path (the plain version of
kernel K11, which a CPU tensor takes) and the driver's marker schedules on
all three forms.

The references are the JAX *generic* path, jitted once per shape; no JAX
kernel runs in interpret mode here (``tests/test_marker_fused.py`` holds the
JAX kernel to that same generic path).

Tolerances: the generic path one update at rtol 1e-8 / atol 1e-10, as the
port's other filters. The lanes path is held to the JAX generic path at
rtol 1e-9 / atol 1e-11, tighter than ``tests/test_marker_fused.py``'s
(position and orientation atol 5e-8, cov rtol 5e-6 / atol 1e-10, NIS rtol
1e-5, innovation rtol 1e-4): it runs a fixed 4 iterations of the S² mean
where the generic mean iterates to 1e-12, and the ±symmetric sigma set makes
the first correction nearly exact, so the two agree to ~1e-14 (measured).
The driver's replays, 1000 ticks with a 4-corner marker tick every 100, are
held to rtol 1e-6 / atol 1e-9, the driver tests' trajectory tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_uwv_kalman_filters_tpu.models import pose_driver as jdrv
from slam_uwv_kalman_filters_tpu.models import pose_ukf as jp
from slam_uwv_kalman_filters_tpu.ops import geodesy as jgeo
from slam_uwv_kalman_filters_tpu.utils.config import CameraConfiguration as JCam
from slam_uwv_kalman_filters_tpu_torch.models import pose_driver as tdrv
from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as tpf
from slam_uwv_kalman_filters_tpu_torch.models import pose_marker_fused as tpmf
from slam_uwv_kalman_filters_tpu_torch.models import pose_ukf as tp
from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
from slam_uwv_kalman_filters_tpu_torch.utils.config import CameraConfiguration as TCam
from slam_uwv_kalman_filters_tpu_torch.utils.convert import from_numpy, to_numpy

from torch_parity import (_quat_exp, _quat_mul, assert_tree_close, banked_params, jx, mission_init, np_tree, pt,
                          random_bank)

STEP = dict(rtol=1e-8, atol=1e-10)
LANES = dict(rtol=1e-9, atol=1e-11)
TRAJ = dict(rtol=1e-6, atol=1e-9)
NB = 4
JCAM, TCAM = JCam(), TCam()
CAM_P = np.array([0.1, -0.05, 0.02])
CAM_Q = np.array([0.5, -0.5, 0.5, -0.5])  # the optical axis along body +x
CORNERS = np.array([[0.15, 0.15, 0.0], [-0.15, 0.15, 0.0], [-0.15, -0.15, 0.0], [0.15, -0.15, 0.0]])
MARKER_P = np.array([6.0, 0.0, 0.0])
MARKER_Q = np.array([0.5, -0.5, 0.5, -0.5])  # facing back toward −x nav
COV_MARKER = np.eye(6) * 1e-3


def _rotate(q, v):
    """R(q)·v in numpy (q (..., 4), v (..., 3))."""
    w, u = q[..., :1], q[..., 1:]
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def _pixels(rng, pos, q, k, mpos=MARKER_P, mq=MARKER_Q, noise=1.0):
    """(B, K, 2) pinhole pixels of the first k corners seen from the body
    poses (B, 3) / (B, 4) through the camera extrinsics, plus pixel noise."""
    f_nav = _rotate(np.asarray(mq)[..., None, :], CORNERS[:k]) + np.asarray(mpos)[..., None, :]
    cam_q = _quat_mul(q, np.broadcast_to(CAM_Q, q.shape))
    cam_p = pos + _rotate(q, np.broadcast_to(CAM_P, pos.shape))
    f = _rotate((cam_q * [1.0, -1.0, -1.0, -1.0])[:, None], f_nav - cam_p[:, None])
    px = np.stack([JCAM.fx * f[..., 0] / f[..., 2] + JCAM.cx, JCAM.fy * f[..., 1] / f[..., 2] + JCAM.cy], -1)
    return px + rng.normal(0.0, noise, px.shape)


@pytest.fixture(scope="module")
def bank():
    """Mission filters with moved means (orientations ~0.15 rad off, so the
    marker stays in view) and correlated covariances at half the initial
    per-field scales, numpy leaves of the JAX types."""
    state, params = mission_init()
    return random_bank(np.random.default_rng(700), state, NB, spread=0.5), params


def _marker_args(feats, k, mpos=MARKER_P, mq=MARKER_Q):
    """The marker arguments after the state and parameters, numpy: covariance
    4 px² per corner, the first k corners."""
    fc = np.broadcast_to(np.eye(2) * 4.0, (*feats.shape[:-1], 2, 2)).copy()
    return feats, fc, CORNERS[:k], np.asarray(mpos), np.asarray(mq), COV_MARKER


def _j(args):
    return (*map(jnp.asarray, args), JCAM, jnp.asarray(CAM_P), jnp.asarray(CAM_Q))


def _t(args):
    return (*(torch.tensor(np.asarray(a)) for a in args), TCAM, torch.tensor(CAM_P), torch.tensor(CAM_Q))


@functools.lru_cache
def _jax_update(bank_form: bool):
    """The JAX generic marker update (solo or bank), jitted: compiled once
    per shape, it runs in a fraction of the eager time."""
    fn = jp.update_visual_features_bank if bank_form else jp.update_visual_features
    return jax.jit(lambda s, p, *a: fn(s, p, *a, JCAM, jnp.asarray(CAM_P), jnp.asarray(CAM_Q)))


def _one(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


def test_visual_landmark_measurement_matches_jax():
    """The bearing model on 119 augmented sigma points (moved poses, a moved
    marker pose)."""
    rng = np.random.default_rng(701)
    state, _ = mission_init()
    n = 119
    q = _quat_mul(np.broadcast_to(state.mu.orientation, (n, 4)), _quat_exp(rng.normal(0.0, 0.2, (n, 3))))
    mq = _quat_mul(np.broadcast_to(MARKER_Q, (n, 4)), _quat_exp(rng.normal(0.0, 0.05, (n, 3))))
    mu = jax.tree.map(lambda a: np.broadcast_to(a, (n, *np.shape(a))).copy(), state.mu)
    chi = jp.PoseStateWithMarker(*mu._replace(position=rng.normal(0.0, 0.5, (n, 3)), orientation=q),
                                 marker_position=MARKER_P + rng.normal(0.0, 0.1, (n, 3)), marker_orientation=mq)
    fp = CORNERS[2]
    ref = jax.vmap(lambda c: jp._visual_landmark_measurement(c, jnp.asarray(fp), jnp.asarray(CAM_Q),
                                                              jnp.asarray(CAM_P)))(jx(chi))
    out = tp._visual_landmark_measurement(pt(chi), torch.tensor(fp), torch.tensor(CAM_Q), torch.tensor(CAM_P))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **STEP)


@pytest.mark.parametrize("k", [1, 4])
def test_update_visual_features_matches_jax(bank, k):
    """The solo update: augmentation, k chained S² corner updates on the
    59-DOF manifold, marginalization and the (K,)-stacked infos."""
    bs, params = bank
    feats = _pixels(np.random.default_rng(702 + k), bs.mu.position, bs.mu.orientation, k)
    for i in (0, 3):
        args = _marker_args(feats[i], k)
        ref, ref_info = _jax_update(False)(jx(_one(bs, i)), jx(params), *_j(args)[:6])
        out, info = tp.update_visual_features(pt(_one(bs, i)), pt(params), *_t(args))
        assert info.mahalanobis2.shape == (k,) and info.innovation.shape == (k, 2) and bool(info.accepted.all())
        assert_tree_close(out, ref, **STEP, what=f"update_visual_features {i}")
        assert_tree_close(info, ref_info, **STEP, what=f"infos {i}")


def test_update_visual_features_rejects_bad_corner_counts(bank):
    bs, params = bank
    s, p = pt(_one(bs)), pt(params)
    args = _t(_marker_args(_pixels(np.random.default_rng(705), bs.mu.position, bs.mu.orientation, 4)[0], 4))
    with pytest.raises(ValueError, match="at least one feature"):
        tp.update_visual_features(s, p, args[0][:0], args[1][:0], args[2][:0], *args[3:])
    with pytest.raises(ValueError, match="4 marker_features but 3 feature_positions"):
        tp.update_visual_features(s, p, args[0], args[1], args[2][:3], *args[3:])
    with pytest.raises(ValueError, match="2 feature_covs"):
        tp.update_visual_features_bank(pt(bs), p, args[0], args[1][:2], *args[2:])
    with pytest.raises(ValueError, match="at least one feature"):
        tpmf.update_visual_features_lanes(tpf.to_lanes(pt(bs)), args[0][:0], args[1][:0], args[2][:0], *args[3:])


@pytest.mark.parametrize("form", ["shared", "per_instance"])
def test_update_visual_features_bank_matches_jax(bank, form):
    """The bank API (generic path on the CPU) with a banked parameter set:
    shared pixels and marker pose, or each instance's own pixels and marker
    pose mean."""
    bs, params = bank
    rng = np.random.default_rng(706)
    params = banked_params(rng, params, NB)
    feats = _pixels(rng, bs.mu.position, bs.mu.orientation, 4)
    if form == "shared":
        args = _marker_args(feats[0], 4)
    else:
        mpos = MARKER_P + rng.normal(0.0, 0.05, (NB, 3))
        mq = _quat_mul(np.broadcast_to(MARKER_Q, (NB, 4)), _quat_exp(rng.normal(0.0, 0.02, (NB, 3))))
        args = _marker_args(feats, 4, mpos, mq / np.linalg.norm(mq, axis=-1, keepdims=True))
    ref, ref_info = _jax_update(True)(jx(bs), jx(params), *_j(args)[:6])
    out, info = tp.update_visual_features_bank(pt(bs), pt(params), *_t(args))
    assert info.mahalanobis2.shape == (NB, 4)
    assert_tree_close(out, ref, **STEP, what=form)
    assert_tree_close(info, ref_info, **STEP, what=f"{form} infos")


# ---------------------------------------------------------------------------
# the lanes path (K11's plain version) against the JAX generic path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["k1_shared", "k4_per_instance"])
def test_lanes_match_jax_generic(bank, case):
    bs, params = bank
    rng = np.random.default_rng(707)
    k = 1 if case == "k1_shared" else 4
    feats = _pixels(rng, bs.mu.position, bs.mu.orientation, k)
    if case == "k1_shared":
        args = _marker_args(feats[0], k)
    else:
        mpos = MARKER_P + rng.normal(0.0, 0.05, (NB, 3))
        mq = _quat_mul(np.broadcast_to(MARKER_Q, (NB, 4)), _quat_exp(rng.normal(0.0, 0.02, (NB, 3))))
        args = _marker_args(feats, k, mpos, mq / np.linalg.norm(mq, axis=-1, keepdims=True))
    ref, ref_info = _jax_update(True)(jx(bs), jx(params), *_j(args)[:6])
    ls, info = tpmf.update_visual_features_lanes(tpf.to_lanes(pt(bs)), *_t(args), nb=NB)
    assert_tree_close(info, ref_info, **LANES, what=f"{case} infos")
    assert_tree_close(tpf.from_lanes(ls, pt(bs)), ref, **LANES, what=case)
    # the fused bank entry point packs, runs the same function and unpacks
    out, info2 = tpmf.update_visual_features_fused_banked(pt(bs), *_t(args))
    assert_tree_close(out, ref, **LANES, what=f"{case} fused_banked")


def _padded_lanes(bs, pad):
    """The port's lanes state padded in the JAX package's convention:
    identity covariances, copies of instance 0."""
    ls = tpf.to_lanes(pt(bs))
    eye = torch.eye(53, dtype=torch.float64)[..., None].expand(53, 53, pad)
    return ls._replace(cov_t=torch.cat([ls.cov_t, eye], -1), mu_t=torch.cat([ls.mu_t, ls.mu_t[:, :1].expand(54, pad)], -1))


def test_padded_bank_stays_finite_and_leaves_the_bank_alone(bank):
    """Three pad lanes (identity covariance; pad corners with bearing (0, 0,
    1), R = I and an identity marker pose) change nothing in the true bank,
    stay finite and are dropped from the infos; a bank that does not fit
    raises."""
    bs, _ = bank
    args = _t(_marker_args(_pixels(np.random.default_rng(708), bs.mu.position, bs.mu.orientation, 4), 4))
    plain, _ = tpmf.update_visual_features_lanes(tpf.to_lanes(pt(bs)), *args)
    padded, info = tpmf.update_visual_features_lanes(_padded_lanes(bs, 3), *args)
    valid = torch.triu(torch.ones(53, 53, dtype=torch.bool))
    assert info.mahalanobis2.shape == (NB, 4) and info.innovation.shape == (NB, 4, 2)
    assert torch.equal(padded.cov_t[..., :NB][valid], plain.cov_t[valid])
    assert torch.equal(padded.mu_t[:, :NB], plain.mu_t)
    assert bool(torch.isfinite(padded.cov_t[valid]).all()) and bool(torch.isfinite(padded.mu_t).all())
    with pytest.raises(ValueError, match="bank of 4 on 3 instances"):
        tpmf.update_visual_features_lanes(padded, *args, nb=NB - 1)


def test_cpu_tensors_take_the_plain_route(bank):
    bs, params = bank
    args = _t(_marker_args(_pixels(np.random.default_rng(709), bs.mu.position, bs.mu.orientation, 1), 1))
    cuda_lib.reset_launch_counts()
    tp.update_visual_features_bank(pt(bs), pt(params), *args)
    tpmf.update_visual_features_lanes(tpf.to_lanes(pt(bs)), *args)
    assert all(k.launches == 0 for k in cuda_lib.KERNELS.values())


# ---------------------------------------------------------------------------
# the driver's marker schedules
# ---------------------------------------------------------------------------


def _consts():
    """The mission constants as a numpy tree of the JAX types (carried to the
    port by ``utils/convert``)."""
    return jdrv.PoseStepConstants(gps_in_body=None, marker=jdrv.MarkerSetup(
        feature_positions=CORNERS, marker_position=MARKER_P, marker_orientation=MARKER_Q,
        cov_marker_pose=np.eye(6) * 1e-4, camera=JCAM, camera_in_imu_position=CAM_P,
        camera_in_imu_orientation=CAM_Q))


def _schedule(rng, T, n, pos):
    """A stationary vehicle at ``pos`` (n, 3) with identity orientation:
    acceleration every tick, DVL 5 Hz, a 4-corner marker sighting from the
    true pose every 100 ticks (tick 99, 199, …; 0.5 px of noise), as
    ``make_inputs`` streams (T·n rows)."""
    g = float(jgeo.wgs84_gravity(0.822, 0.0))
    k = np.arange(T)
    every = lambda period: np.repeat((k % period == period - 1)[:, None], n, 1).reshape(-1)
    q = np.broadcast_to([1.0, 0.0, 0.0, 0.0], (n, 4))
    feats = np.stack([_pixels(rng, pos, q, 4, noise=0.5) for _ in range(T)]).reshape(T * n, 4, 2)
    return dict(
        acc=(np.array([0.0, 0.0, g]) + rng.normal(scale=2e-3, size=(T, n, 3))).reshape(-1, 3),
        acc_cov=np.eye(3) * 4e-5,
        dvl=rng.normal(scale=1e-2, size=(T * n, 3)), dvl_cov=np.eye(3) * 1e-3, dvl_valid=every(20),
        marker_features=feats, marker_feature_covs=np.tile(np.eye(2) * 0.25, (4, 1, 1)),
        marker_valid=every(100),
    )


def _inputs(T, n, kw, banked=True):
    """The schedule from both packages' ``make_inputs``, (T, n, …) (or (T,
    …) for one filter) without the streams the mission lacks: (JAX, port)."""
    rot = np.tile([0.0, 0.0, 1e-3], (T * n, 1))
    j = jdrv.make_inputs(T * n, 0.01, rot, **kw, dtype=jnp.float64)
    t = tdrv.make_inputs(T * n, 0.01, torch.tensor(rot), **{k: torch.tensor(np.asarray(v)) for k, v in kw.items()},
                         device="cpu")
    lean = dict(pressure=None, pressure_cov=None, pressure_valid=None, xy=None, xy_cov=None, xy_valid=None,
                adcp=None, adcp_cov=None, adcp_cell_weighting=None, adcp_valid=None, efforts=None,
                efforts_cov=None, efforts_valid=None)
    shape = lambda x: x.reshape(T, n, *x.shape[1:]) if banked else x
    return (jax.tree.map(shape, j._replace(**lean)),
            tdrv.PoseInputs(*(None if x is None else shape(x) for x in t._replace(**lean))))


def _close_outputs(out, ref, tol):
    out, ref = to_numpy(out), np_tree(ref)
    for name in ("position", "orientation", "velocity", "cov_trace", "dvl_nis", "marker_nis"):
        np.testing.assert_allclose(getattr(out, name), getattr(ref, name), **tol, err_msg=name)


def test_solo_marker_schedule_matches_jax():
    """``run_trajectory`` (``pose_step`` each tick) on one filter over 200
    ticks with two marker sightings; the NIS is 0 off the schedule, and a
    tick whose sighting is invalid keeps the filter as without the stream."""
    state, params = mission_init()
    T = 200
    kw = _schedule(np.random.default_rng(710), T, 1, state.mu.position[None] + [0.05, -0.03, 0.02])
    jin, tin = _inputs(T, 1, kw, banked=False)
    consts = _consts()
    ref_s, ref_o = jax.jit(lambda s, p, i: jdrv.run_trajectory(s, p, i, consts))(jx(state), jx(params), jin)
    out_s, out_o = tdrv.run_trajectory(pt(state), pt(params), tin, from_numpy(consts, device="cpu"))
    assert_tree_close(out_s, ref_s, **TRAJ, what="solo")
    _close_outputs(out_o, ref_o, TRAJ)
    nis = out_o.marker_nis.numpy()
    assert nis.shape == (T, 4) and np.all(nis[np.arange(T) % 100 != 99] == 0.0) and np.all(nis[99::100] > 0.0)
    # pose_step itself: an invalid sighting is a masked no-op
    tick = tdrv.PoseInputs(*(None if x is None else x[0] for x in tin))
    with_marker, o = tdrv.pose_step(pt(state), pt(params), tick, from_numpy(consts, device="cpu"))
    without, _ = tdrv.pose_step(pt(state), pt(params), tick._replace(marker_features=None, marker_feature_covs=None,
                                                                     marker_valid=None))
    assert_tree_close(with_marker, np_tree(to_numpy(without)), rtol=0, atol=0, what="masked")
    assert torch.equal(o.marker_nis, torch.zeros(4, dtype=torch.float64))


@pytest.fixture(scope="module")
def banked_replay():
    """1000 ticks at bank 2 with a banked parameter set (a Monte-Carlo
    draw), a 4-corner marker sighting every 100 ticks: the JAX generic bank
    replay and the port's inputs."""
    n, T = 2, 1000
    state, params = mission_init()
    rng = np.random.default_rng(711)
    params = banked_params(rng, params, n)
    pos = state.mu.position + rng.normal(scale=0.1, size=(n, 3))
    bstate = jax.tree.map(lambda a: np.broadcast_to(a, (n, *np.shape(a))).copy(), state)
    bstate = bstate._replace(mu=bstate.mu._replace(position=pos + rng.normal(scale=0.05, size=(n, 3))))
    jin, tin = _inputs(T, n, _schedule(rng, T, n, pos))
    consts = _consts()
    ref = jax.jit(lambda s, p, i: jdrv.run_trajectory_bank(s, p, i, consts, use_fused=False))(
        jx(bstate), jx(params), jin)
    return bstate, params, tin, from_numpy(consts, device="cpu"), ref


@pytest.mark.parametrize("form", ["bank", "lanes"])
def test_banked_marker_trajectory_1000_ticks_matches_jax(banked_replay, form):
    """``run_trajectory_bank`` (the generic path on the CPU) and
    ``run_trajectory_bank_lanes`` (K2 full mode, K3 and K11, plain versions)
    over the 1000-tick banked replay against the JAX generic bank replay;
    the marker NIS is finite on the sighting ticks and 0 elsewhere."""
    bstate, params, tin, consts, (ref_s, ref_o) = banked_replay
    run = tdrv.run_trajectory_bank if form == "bank" else tdrv.run_trajectory_bank_lanes
    out_s, out_o = run(pt(bstate), pt(params), tin, consts)
    assert bool(torch.isfinite(out_s.cov).all())
    assert_tree_close(out_s, ref_s, **TRAJ, what=form)
    _close_outputs(out_o, ref_o, TRAJ)
    nis = out_o.marker_nis.numpy()
    on = np.arange(1000) % 100 == 99
    assert nis.shape == (1000, 2, 4) and np.all(nis[~on] == 0.0) and np.all(np.isfinite(nis[on]))
    assert np.all(nis[on] > 0.0)

"""Parity of the PyTorch port's IndirectPoseUKF — the rigid-transform
helpers, the generic filter (init, predict, the pixel conversions, the
marker update with state augmentation, the bank forms with banked sweeps and
per-instance marker data, the class wrapper) and the lanes path (the plain
versions of kernels K9 and K10, which a CPU tensor takes) — with the JAX
package at float64 on the CPU.

Tolerances: the generic path one step at rtol 1e-8 / atol 1e-10, as the
port's other filters. The lanes path is held to the JAX *generic* path at
rtol 1e-9 / atol 1e-11 per step: it runs a fixed 4 Karcher iterations (SO(3)
in the predict, S² over the bearings) where the generic means iterate to
1e-12, takes the predicted position mean as pos + Σδ/13 and composes the
bearing model as R(q⁻¹)(f − p); the ±symmetric sigma set makes the first
Karcher correction nearly exact, so the two agree to rounding. A 1000-step
trajectory (predict at dt 0.1, a moving pose reference, a 4-corner marker
update every 10th step) of the lanes path against the JAX generic path is
held to rtol 1e-6 / atol 1e-9. The two float32 comparisons with the JAX
kernels in interpret mode (bank 128) hold covariances to rtol 2e-5 / atol
2e-6, the predicted mean too, and the marker update's mean and infos to
rtol 1e-4 / atol 2e-5 (see each test).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_uwv_kalman_filters_tpu.models import indirect_fused as jif
from slam_uwv_kalman_filters_tpu.models import indirect_pose_ukf as ji
from slam_uwv_kalman_filters_tpu.ops import manifolds as jmf
from slam_uwv_kalman_filters_tpu.utils.config import CameraConfiguration as JCam
from slam_uwv_kalman_filters_tpu_torch.models import indirect_fused as tif
from slam_uwv_kalman_filters_tpu_torch.models import indirect_pose_ukf as ti
from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
from slam_uwv_kalman_filters_tpu_torch.ops import manifolds as tmf
from slam_uwv_kalman_filters_tpu_torch.utils.config import CameraConfiguration as TCam
from slam_uwv_kalman_filters_tpu_torch.utils.convert import from_numpy

from torch_parity import _quat_exp, _quat_mul, assert_tree_close, jx, np_tree, pt, random_spd

STEP = dict(rtol=1e-8, atol=1e-10)
LANES = dict(rtol=1e-9, atol=1e-11)
TRAJ = dict(rtol=1e-6, atol=1e-9)
DT = 0.1
NB = 6
JCAM, TCAM = JCam(), TCam()


def _unit(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _bank(rng, nb=NB):
    """Filters with moved error means (orientation errors up to ~0.3 rad),
    random correlated covariances and pose references, numpy leaves of the
    JAX types; a symmetric process noise with cross terms."""
    params = np_tree(ji.init((0.05,) * 3, (0.02,) * 3, 30.0)[1])
    bs = ji.IndirectPoseUKFState(
        mu=ji.PoseErrorState(position_error=rng.normal(0.0, 0.2, (nb, 3)),
                             orientation_error=_quat_exp(rng.normal(0.0, 0.15, (nb, 3)))),
        cov=random_spd(rng, 6, nb, np.array([0.3, 0.2, 0.25, 0.05, 0.04, 0.06])),
        pose_ref_position=rng.normal(0.0, 0.5, (nb, 3)),
        pose_ref_orientation=_quat_exp(rng.normal(0.0, 0.1, (nb, 3))),
    )
    a = rng.normal(size=(6, 6)) * 0.01
    return bs, params._replace(process_noise=params.process_noise + a @ a.T)


def _rotate(q, v):
    """R(q)·v in numpy (q (..., 4), v (..., 3))."""
    w, u = q[..., :1], q[..., 1:]
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def _project(feature_nav, body_q, body_p, cam_q, cam_p):
    """Pinhole pixels (B, K, 2) of nav-frame points (K, 3) seen from the
    true body poses (B, 4) / (B, 3) through the camera extrinsics."""
    q = _quat_mul(body_q, cam_q)[:, None]
    p = (body_p + _rotate(body_q, cam_p))[:, None]
    f = _rotate(q * [1.0, -1.0, -1.0, -1.0], feature_nav[None] - p)
    return np.stack([JCAM.fx * f[..., 0] / f[..., 2] + JCAM.cx, JCAM.fy * f[..., 1] / f[..., 2] + JCAM.cy], -1)


CORNERS = np.array([[-0.15, -0.15, 0.0], [0.15, -0.15, 0.0], [0.15, 0.15, 0.0], [-0.15, 0.15, 0.0]])
MARKER_P = np.array([0.3, -0.2, 3.0])
MARKER_Q = _quat_exp(np.array([0.02, -0.05, 0.1]))
CAM_P = np.array([0.1, 0.0, 0.05])
CAM_Q = _quat_exp(np.array([0.01, -0.02, 0.03]))
COV_MARKER = random_spd(np.random.default_rng(599), 6, 1, np.array([1e-2, 1e-2, 1e-2, 3e-3, 3e-3, 3e-3]))[0]


def _pixels(rng, bs, k, bias=(0.1, -0.05, 0.08), noise=1.0):
    """(B, K, 2) pixels of the first k corners seen from the true pose ref ∘
    bias of each instance, plus pixel noise."""
    corners = _rotate(MARKER_Q, CORNERS[:k]) + MARKER_P
    px = _project(corners, np.asarray(bs.pose_ref_orientation), np.asarray(bs.pose_ref_position) + bias, CAM_Q, CAM_P)
    return px + rng.normal(0.0, noise, px.shape)


def _marker_args(feats, k):
    """The shared marker arguments after the features, numpy."""
    return (np.broadcast_to(np.eye(2) * 4.0, (*feats.shape[:-1], 2, 2)).copy(), CORNERS[:k], MARKER_P, MARKER_Q,
            COV_MARKER)


def _jargs(feats, k, extra=()):
    """The JAX marker arguments before the camera (see :func:`_jax_markers`)."""
    fc, fp, mp, mq, cm = _marker_args(feats, k)
    return (jnp.asarray(feats), jnp.asarray(fc), jnp.asarray(fp), *(jnp.asarray(a) for a in extra or (mp, mq)),
            jnp.asarray(cm))


@functools.lru_cache
def _jax_markers(bank: bool):
    """The JAX generic marker update (solo or bank) with this file's camera,
    jitted: compiled once per shape, it runs in a fraction of the eager
    time."""
    fn = functools.partial(ji.update_markers_bank, use_fused=False) if bank else ji.update_markers
    return jax.jit(lambda s, *args: fn(s, *args, JCAM, jnp.asarray(CAM_P), jnp.asarray(CAM_Q)))


@functools.lru_cache
def _jax_predict_solo():
    return jax.jit(lambda s, p: ji.predict(s, p, DT))


@functools.lru_cache
def _jax_predict():
    return jax.jit(lambda s, p: ji.predict_bank(s, p, DT, use_fused=False))


def _targs(feats, k, extra=()):
    fc, fp, mp, mq, cm = _marker_args(feats, k)
    t = torch.tensor
    return (t(feats), t(fc), t(fp), *(t(np.asarray(a)) for a in extra or (mp, mq)), t(cm), TCAM, t(CAM_P), t(CAM_Q))


def _one(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


@pytest.fixture(scope="module")
def bank():
    return _bank(np.random.default_rng(600))


def test_affine_helpers_match_jax():
    rng = np.random.default_rng(601)
    qa, qb = _quat_exp(rng.normal(0, 1, (5, 3))), _quat_exp(rng.normal(0, 1, (5, 3)))
    pa, pb, v = rng.normal(size=(5, 3)), rng.normal(size=(5, 3)), rng.normal(size=(5, 3))
    t, j = torch.tensor, jnp.asarray
    ref = jax.vmap(jmf.affine_mul)(j(qa), j(pa), j(qb), j(pb))
    out = tmf.affine_mul(t(qa), t(pa), t(qb), t(pb))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **STEP)
    for o, r in zip(tmf.affine_inv(t(qa), t(pa)), jax.vmap(jmf.affine_inv)(j(qa), j(pa))):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **STEP)
    np.testing.assert_allclose(tmf.affine_apply(t(qa), t(pa), t(v)).numpy(),
                               np.asarray(jax.vmap(jmf.affine_apply)(j(qa), j(pa), j(v))), **STEP)


def test_init_predict_and_pixel_conversions_match_jax(bank):
    ref_s, ref_p = ji.init((0.05, 0.06, 0.07), (0.02, 0.03, 0.01), 25.0, initial_position_error=(0.1, 0.2, 0.3),
                           initial_position_error_std=(0.5, 0.6, 0.7))
    out_s, out_p = ti.init((0.05, 0.06, 0.07), (0.02, 0.03, 0.01), 25.0, initial_position_error=(0.1, 0.2, 0.3),
                           initial_position_error_std=(0.5, 0.6, 0.7), device="cpu")
    assert_tree_close(out_s, ref_s, rtol=0, atol=0, what="init state")
    assert_tree_close(out_p, ref_p, rtol=0, atol=0, what="init params")
    bs, params = bank
    for i in range(3):
        ref = _jax_predict_solo()(jx(_one(bs, i)), jx(params))
        assert_tree_close(ti.predict(pt(_one(bs, i)), pt(params), DT), ref, **STEP, what=f"predict {i}")
    px = np.random.default_rng(602).normal([320.0, 240.0], 80.0, (7, 2))
    pc = random_spd(np.random.default_rng(603), 2, 7, np.array([2.0, 3.0]))
    np.testing.assert_allclose(ti.pixel_to_s2(torch.tensor(px), TCAM).numpy(),
                               np.asarray(jax.vmap(lambda p: ji.pixel_to_s2(p, JCAM))(jnp.asarray(px))), **STEP)
    np.testing.assert_allclose(ti.pixel_cov_to_s2(torch.tensor(pc), TCAM).numpy(),
                               np.asarray(ji.pixel_cov_to_s2(jnp.asarray(pc), JCAM)), **STEP)


@pytest.mark.parametrize("k", [1, 4])
def test_update_markers_matches_jax(bank, k):
    """The solo marker update: augmentation, k chained S² corner updates,
    marginalization and the (K,)-stacked infos."""
    bs, _ = bank
    feats = _pixels(np.random.default_rng(604 + k), bs, k)
    for i in (0, 3):
        ref, ref_info = _jax_markers(False)(jx(_one(bs, i)), *_jargs(feats[i], k))
        out, info = ti.update_markers(pt(_one(bs, i)), *_targs(feats[i], k))
        assert_tree_close(out, ref, **STEP, what=f"update_markers {i}")
        assert info.mahalanobis2.shape == (k,) and info.innovation.shape == (k, 2) and bool(info.accepted.all())
        assert_tree_close(info, ref_info, **STEP, what=f"infos {i}")


def test_update_markers_rejects_bad_corner_counts(bank):
    bs, _ = bank
    s = pt(_one(bs))
    feats = _pixels(np.random.default_rng(606), bs, 4)[0]
    with pytest.raises(ValueError, match="at least one feature"):
        ti.update_markers(s, *_targs(feats[:0], 0))
    args = list(_targs(feats, 4))
    args[2] = args[2][:3]
    with pytest.raises(ValueError, match="4 marker_features but 3 feature_positions"):
        ti.update_markers(s, *args)
    args = list(_targs(feats, 4))
    args[1] = args[1][:2]
    with pytest.raises(ValueError, match="2 feature_covs"):
        ti.update_markers_bank(pt(bs), *args)


def test_bank_paths_match_jax(bank):
    """The bank API (generic path on the CPU): predict with a shared
    parameter set, a banked τ sweep and a banked Q sweep; the marker update
    with shared features and with per-instance features and marker poses."""
    bs, params = bank
    rng = np.random.default_rng(607)
    scale = 1.0 + 0.3 * rng.uniform(-1.0, 1.0, NB)
    sweeps = {"shared": params,
              "tau": params._replace(orientation_error_tau=params.orientation_error_tau * scale),
              "q": params._replace(process_noise=params.process_noise[None] * scale[:, None, None])}
    for name, p in sweeps.items():
        ref = _jax_predict()(jx(bs), jx(p))
        out = ti.predict_bank(pt(bs), pt(p), DT)
        assert_tree_close(out, ref, **STEP, what=f"predict_bank {name}")
    feats = _pixels(rng, bs, 4)
    shared = feats[0]
    ref, ref_info = _jax_markers(True)(jx(bs), *_jargs(shared, 4))
    out, info = ti.update_markers_bank(pt(bs), *_targs(shared, 4))
    assert_tree_close(out, ref, **STEP, what="update_markers_bank shared")
    assert_tree_close(info, ref_info, **STEP, what="update_markers_bank shared infos")
    mpos = MARKER_P + rng.normal(0.0, 0.05, (NB, 3))
    mrot = _unit(_quat_mul(np.broadcast_to(MARKER_Q, (NB, 4)), _quat_exp(rng.normal(0.0, 0.02, (NB, 3)))))
    ref, ref_info = _jax_markers(True)(jx(bs), *_jargs(feats, 4, (mpos, mrot)))
    out, info = ti.update_markers_bank(pt(bs), *_targs(feats, 4, (mpos, mrot)))
    assert info.mahalanobis2.shape == (NB, 4)
    assert_tree_close(out, ref, **STEP, what="update_markers_bank per instance")
    assert_tree_close(info, ref_info, **STEP, what="update_markers_bank per-instance infos")


def test_class_wrapper(bank):
    """The port's class against the JAX generic functions it wraps (jitted:
    the JAX class runs them eagerly, at seconds per call here)."""
    bs, _ = bank
    kw = dict(initial_position_error=(0.2, -0.1, 0.05), initial_position_error_std=(0.3, 0.3, 0.3))
    ref, ref_params = ji.init((0.05,) * 3, (0.02,) * 3, 30.0, **kw)
    f = ti.IndirectPoseUKF((0.05,) * 3, (0.02,) * 3, 30.0, **kw, device="cpu")
    ref_p, ref_q = np.asarray(bs.pose_ref_position[1]), np.asarray(bs.pose_ref_orientation[1])
    ref = ji.update_pose_reference(ref, jnp.asarray(ref_p), jnp.asarray(ref_q))
    ref = _jax_predict_solo()(ref, ref_params._replace(process_noise=jnp.eye(6) * 1e-3))
    f.set_process_noise_covariance(np.eye(6) * 1e-3)
    f.update_pose_reference(ref_p, ref_q)
    f.prediction_step(DT)
    feats = _pixels(np.random.default_rng(608), jax.tree.map(lambda a: a[1:2], bs), 4)[0]
    ref, ref_info = _jax_markers(False)(ref, *_jargs(feats, 4))
    fc, fp, mp, mq, cm = _marker_args(feats, 4)
    info = f.integrate_marker_measurement(feats, fc, fp, mp, mq, cm, TCAM, CAM_P, CAM_Q)
    assert_tree_close(info, ref_info, **STEP, what="class infos")
    assert_tree_close(f.state, ref, **STEP, what="class state")
    assert_tree_close(f.mu, ref.mu, **STEP)
    for o, r in zip(f.get_corrected_pose(), ji.corrected_pose(ref)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **STEP)
    bad = feats.copy()
    bad[2, 0] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        f.integrate_marker_measurement(bad, fc, fp, mp, mq, cm, TCAM, CAM_P, CAM_Q)


# ---------------------------------------------------------------------------
# the lanes path (K9's and K10's plain versions) against the JAX generic path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["predict", "k1", "k4", "k4_per_instance"])
def test_lanes_match_jax_generic(bank, case):
    bs, params = bank
    rng = np.random.default_rng(609)
    ref = _jax_predict()(jx(bs), jx(params))
    ls = tif.predict_lanes(tif.to_lanes(pt(bs)), pt(params), DT)
    if case != "predict":
        k = 1 if case == "k1" else 4
        feats = _pixels(rng, np_tree(ref), k)
        if case == "k4_per_instance":
            mpos = MARKER_P + rng.normal(0.0, 0.05, (NB, 3))
            mrot = _unit(_quat_mul(np.broadcast_to(MARKER_Q, (NB, 4)), _quat_exp(rng.normal(0.0, 0.02, (NB, 3)))))
            jargs, targs = _jargs(feats, k, (mpos, mrot)), _targs(feats, k, (mpos, mrot))
        else:
            jargs, targs = _jargs(feats[0], k), _targs(feats[0], k)
        ref, ref_info = _jax_markers(True)(ref, *jargs)
        ls, info = tif.update_markers_lanes(ls, *targs, nb=NB)
        assert_tree_close(info, ref_info, **LANES, what=f"{case} infos")
    assert_tree_close(tif.from_lanes(ls, pt(bs)), ref, **LANES, what=case)


def test_pad_lanes_stay_finite_and_leave_the_bank_alone(bank):
    """Three pad lanes (identity covariance, copies of instance 0; pad
    corners with bearing (0, 0, 1), R = I and an identity marker pose)
    change nothing in the true bank and stay finite; the infos drop them."""
    bs, params = bank
    feats = _pixels(np.random.default_rng(610), bs, 4)
    outs = []
    for lanes in (None, NB + 3):
        ls = tif.predict_lanes(tif.to_lanes(pt(bs), lanes=lanes), pt(params), DT)
        outs.append(tif.update_markers_lanes(ls, *_targs(feats, 4), nb=NB))
    (plain, _), (padded, info) = outs
    assert padded.cov_t.shape[-1] == NB + 3 and info.mahalanobis2.shape == (NB, 4)
    assert torch.equal(padded.cov_t[..., :NB], plain.cov_t) and torch.equal(padded.mu_t[:, :NB], plain.mu_t)
    assert bool(torch.isfinite(padded.cov_t).all()) and bool(torch.isfinite(padded.mu_t).all())
    with pytest.raises(ValueError, match="bank of 6 on 5 instances"):
        tif.update_markers_lanes(padded, *_targs(feats, 4), nb=NB - 1)


def test_lanes_layout_and_bank_inference_match_jax(bank):
    """The JAX package's lanes state (padded to its 128-lane tile), carried
    over by ``utils/convert``, equals the port's ``to_lanes`` padded to the
    same width; per-instance features of a bank of one infer nb = 1 on a
    padded state."""
    bs, params = bank
    ref = jif.to_lanes(jx(bs))
    lanes = np.asarray(ref.cov_t).shape[-1]
    mine = tif.to_lanes(pt(bs), lanes=lanes)
    for got, want in zip(mine, from_numpy(np_tree(ref), device="cpu")):
        assert torch.equal(got, want)
    assert_tree_close(tif.from_lanes(mine, pt(bs)), bs, rtol=0, atol=0)
    one = jax.tree.map(lambda a: a[:1], bs)
    feats = _pixels(np.random.default_rng(614), one, 4)
    _, info = tif.update_markers_lanes(tif.to_lanes(pt(one), lanes=4), *_targs(feats, 4))
    assert info.mahalanobis2.shape == (1, 4) and info.innovation.shape == (1, 4, 2)


def test_cpu_tensors_take_the_plain_route(bank):
    bs, params = bank
    feats = _pixels(np.random.default_rng(611), bs, 1)
    cuda_lib.reset_launch_counts()
    out = ti.predict_bank(pt(bs), pt(params), DT)
    tif.predict_fused_banked(pt(bs), pt(params), DT)
    ti.update_markers_bank(out, *_targs(feats, 1))
    tif.update_markers_fused_banked(out, *_targs(feats, 1))
    assert all(k.launches == 0 for k in cuda_lib.KERNELS.values())
    banked = params._replace(orientation_error_tau=np.full(NB, 30.0))
    with pytest.raises(ValueError, match="generic path"):
        tif.predict_lanes(tif.to_lanes(pt(bs)), pt(banked), DT)


def test_lanes_trajectory_matches_jax_generic(bank):
    """1000 steps at bank 3 of the lanes path against the JAX generic path:
    predict at dt 0.1 every step with the pose reference moved along a
    path, and a 4-corner marker update (per-instance pixels seen from ref ∘
    a true bias, 1 px of noise) every 10th step."""
    bs, params = bank
    nb, n_steps, k = 3, 1000, 4
    bs = jax.tree.map(lambda a: a[:nb], bs)
    rng = np.random.default_rng(612)
    t = np.arange(n_steps) * DT
    ref_p = np.stack([0.3 * np.sin(0.05 * t), 0.2 * np.cos(0.07 * t), 0.05 * np.sin(0.11 * t)], -1)
    ref_p = ref_p[:, None] + np.asarray(bs.pose_ref_position)[None]
    ref_q = _quat_exp(np.stack([0.02 * np.sin(0.03 * t), 0.03 * np.cos(0.04 * t), 0.1 * np.sin(0.02 * t)], -1))
    ref_q = np.broadcast_to(ref_q[:, None], (n_steps, nb, 4)).copy()
    p = jx(params)

    predict = _jax_predict()

    ref = jx(bs)
    ls = tif.to_lanes(pt(bs))
    tp = pt(params)
    for i in range(n_steps):
        ls = tif.predict_lanes(ls._replace(ref_t=torch.tensor(np.concatenate([ref_p[i], ref_q[i]], -1).T).contiguous()),
                               tp, DT)
        ref = predict(ref._replace(pose_ref_position=jnp.asarray(ref_p[i]), pose_ref_orientation=jnp.asarray(ref_q[i])),
                      p)
        if i % 10 == 9:
            feats = _pixels(rng, bs._replace(pose_ref_position=ref_p[i], pose_ref_orientation=ref_q[i]), k)
            ls, _ = tif.update_markers_lanes(ls, *_targs(feats, k))
            ref = _jax_markers(True)(ref, *_jargs(feats, k))[0]
    out = tif.from_lanes(ls, pt(np_tree(ref)))
    assert bool(torch.isfinite(out.cov).all())
    assert_tree_close(out, ref, **TRAJ, what="trajectory")
    # the marker updates have pulled the position error to the true bias,
    # within the marker pose's own uncertainty (0.1 m per axis)
    np.testing.assert_allclose(out.mu.position_error.numpy(), np.broadcast_to([0.1, -0.05, 0.08], (nb, 3)),
                               atol=0.1)


# ---------------------------------------------------------------------------
# once per kernel: the plain versions at float32 against the JAX kernels
# (Pallas interpret mode)
# ---------------------------------------------------------------------------


def _f32_bank(bank):
    bs, params = bank
    big = jax.tree.map(lambda a: np.concatenate([a] * 22)[:128].astype(np.float32), bs)
    return big, jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def _assert_lanes_close(ls, ref_ls, tol):
    for name in ("cov_t", "mu_t"):
        np.testing.assert_allclose(getattr(ls, name).numpy(), np.asarray(getattr(ref_ls, name)), **tol, err_msg=name)


def test_predict_plain_matches_jax_kernel_float32(bank):
    """K9's plain version at float32 against the JAX kernel at bank 128: the
    lanes layout, the per-lane rotated Q and the in-kernel SO(3) algebra.
    Both round float32; they differ in the log map's arctangent (the TPU
    kernel's is a polynomial) and in the order of the sums, so the bound is
    a few float32 ulps of the entries: rtol 2e-5 / atol 2e-6."""
    big, p32 = _f32_bank(bank)
    ref_ls = jif.predict_lanes(jif.to_lanes(jx(big)), jx(p32), DT, interpret=True)
    ls = tif.predict_lanes(tif.to_lanes(from_numpy(big, device="cpu", dtype=torch.float32)),
                           from_numpy(p32, device="cpu", dtype=torch.float32), DT)
    _assert_lanes_close(ls, ref_ls, dict(rtol=2e-5, atol=2e-6))


def test_markers_plain_matches_jax_kernel_float32(bank):
    """K10's plain version at float32 against the JAX kernel at bank 128 with
    2 corners and per-instance pixels: the augmentation, 25 sigma bearings
    with their S² mean, the chained 12-DOF tails and the marginalization.
    The covariance is held to rtol 2e-5 / atol 2e-6 as above. The gain
    divides by S ~ 1e-5 rad² (R = 4 px² at f = 500), which amplifies the
    float32 rounding of the bearings: each float32 version's mean, NIS and
    innovations land up to ~2e-5 (relative) from the float64 result
    (measured). So these are held to the JAX kernel at rtol 1e-4 / atol
    2e-5, and the port's own float32 error, |Δ|/(1 + |x|) against its
    float64 plain version (itself held to the JAX generic path above), to
    1e-4.
    """
    big, _ = _f32_bank(bank)
    feats = _pixels(np.random.default_rng(613), big, 2)
    f32 = [a.astype(np.float32) for a in (feats, *_marker_args(feats, 2), CAM_P, CAM_Q)]
    ref_ls, ref_info = jif.update_markers_lanes(jif.to_lanes(jx(big)), *map(jnp.asarray, f32[:6]), JCAM,
                                                *map(jnp.asarray, f32[6:]), interpret=True)

    def port(dtype):
        t = lambda a: torch.tensor(a).to(dtype)
        return tif.update_markers_lanes(tif.to_lanes(from_numpy(big, device="cpu", dtype=dtype)), *map(t, f32[:6]),
                                        TCAM, *map(t, f32[6:]))

    (ls, info), (ls64, info64) = port(torch.float32), port(torch.float64)
    np.testing.assert_allclose(ls.cov_t.numpy(), np.asarray(ref_ls.cov_t), rtol=2e-5, atol=2e-6)
    err = lambda a, x: float((np.abs(np.asarray(a, np.float64) - x.numpy()) / (1.0 + np.abs(x.numpy()))).max())
    for name, got, want, exact in (("mu", ls.mu_t, ref_ls.mu_t, ls64.mu_t),
                                   ("m2", info.mahalanobis2, ref_info.mahalanobis2, info64.mahalanobis2),
                                   ("nu", info.innovation, ref_info.innovation, info64.innovation)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=2e-5, err_msg=name)
        assert err(got, exact) <= 1e-4, (name, err(got, exact), err(want, exact))

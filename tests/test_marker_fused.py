"""Parity of the fused 59-DOF visual-marker kernel
(``models/pose_marker_fused.py``) against the generic augmented-state path
(``pose_ukf.update_visual_features_bank``) — same semantics
(``/root/reference/src/PoseUKF.cpp:613-654``), augmentation in VMEM instead
of a bank-layout round trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_uwv_kalman_filters_tpu.models import pose_fused as pf
from slam_uwv_kalman_filters_tpu.models import pose_marker_fused as pmf
from slam_uwv_kalman_filters_tpu.models import pose_ukf as pukf
from slam_uwv_kalman_filters_tpu.ops import dynamics as dyn
from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod
from slam_uwv_kalman_filters_tpu.utils.config import (
    CameraConfiguration,
    default_pose_ukf_config,
)

CAM = CameraConfiguration()
CAM_P = np.array([0.1, -0.05, 0.02])
CAM_Q = np.array([0.5, -0.5, 0.5, -0.5])  # optical axis along +x body
CORNERS = np.array(
    [[0.15, 0.15, 0.0], [-0.15, 0.15, 0.0], [-0.15, -0.15, 0.0], [0.15, -0.15, 0.0]]
)


def _project(pos, q, marker_pos, marker_q):
    import oracle as orc

    R = orc.q_to_mat(q)
    Rc = orc.q_to_mat(CAM_Q)
    Rm = orc.q_to_mat(marker_q)
    px = np.zeros((len(CORNERS), 2))
    for i, c in enumerate(CORNERS):
        p_nav = marker_pos + Rm @ c
        p_cam = Rc.T @ (R.T @ (p_nav - pos) - CAM_P)
        px[i] = [
            CAM.fx * p_cam[0] / p_cam[2] + CAM.cx,
            CAM.fy * p_cam[1] / p_cam[2] + CAM.cy,
        ]
    return px


def _bank(n, dtype, seed=11):
    rng = np.random.default_rng(seed)
    cfg = default_pose_ukf_config()
    state, params = pukf.init_from_pose(
        imu_in_nwu_pos=jnp.zeros(3, dtype),
        imu_in_nwu_pos_cov=jnp.eye(3, dtype=dtype) * 0.04,
        imu_in_nwu_rot=jnp.array([1.0, 0, 0, 0], dtype),
        imu_in_nwu_rot_cov=jnp.eye(3, dtype=dtype) * 1e-4,
        config=cfg,
        model_parameters=dyn.default_uwv_parameters(dtype=dtype),
        imu_delta_t=0.05,
        dtype=dtype,
    )
    bstate = bankmod.replicate(state, n)
    bstate = bstate._replace(
        mu=bstate.mu._replace(
            position=jnp.asarray(rng.normal(scale=0.3, size=(n, 3)), dtype),
            velocity=jnp.asarray(rng.normal(scale=0.2, size=(n, 3)), dtype),
        )
    )
    return bstate, params, rng


@pytest.mark.slow
def test_marker_lanes_matches_generic_bank():
    n = 3
    dtype = jnp.float64
    bstate, params, rng = _bank(n, dtype)
    marker_pos = np.array([6.0, 0.0, 0.0])
    marker_q = np.array([0.5, -0.5, 0.5, -0.5])
    feats = np.stack(
        [
            _project(
                np.asarray(bstate.mu.position[i], np.float64),
                np.asarray(bstate.mu.orientation[i], np.float64),
                marker_pos,
                marker_q,
            )
            + rng.normal(scale=1.0, size=(4, 2))
            for i in range(n)
        ]
    )
    fcovs = np.tile(np.eye(2) * 4.0, (4, 1, 1))
    cov_marker = np.eye(6) * 1e-3

    ref_state, ref_info = pukf.update_visual_features_bank(
        bstate, params,
        jnp.asarray(feats, dtype), jnp.asarray(fcovs, dtype),
        jnp.asarray(CORNERS, dtype),
        jnp.asarray(marker_pos, dtype), jnp.asarray(marker_q, dtype),
        jnp.asarray(cov_marker, dtype), CAM,
        jnp.asarray(CAM_P, dtype), jnp.asarray(CAM_Q, dtype),
    )

    ls, info = pmf.update_visual_features_lanes(
        pf.to_lanes(bstate),
        jnp.asarray(feats, dtype), jnp.asarray(fcovs, dtype),
        jnp.asarray(CORNERS, dtype),
        jnp.asarray(marker_pos, dtype), jnp.asarray(marker_q, dtype),
        jnp.asarray(cov_marker, dtype), CAM,
        jnp.asarray(CAM_P, dtype), jnp.asarray(CAM_Q, dtype),
        nb=n, interpret=True,
    )
    out = pf.from_lanes(ls, bstate)

    np.testing.assert_allclose(
        np.asarray(out.mu.position), np.asarray(ref_state.mu.position), atol=5e-8
    )
    np.testing.assert_allclose(
        np.asarray(out.mu.orientation), np.asarray(ref_state.mu.orientation), atol=5e-8
    )
    np.testing.assert_allclose(
        np.asarray(out.cov), np.asarray(ref_state.cov), rtol=5e-6, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(info.mahalanobis2), np.asarray(ref_info.mahalanobis2),
        rtol=1e-5, atol=1e-8,
    )
    np.testing.assert_allclose(
        np.asarray(info.innovation), np.asarray(ref_info.innovation),
        rtol=1e-4, atol=1e-8,
    )


@pytest.mark.time_limit(260)
def test_marker_lanes_padded_bank_f32():
    """A non-lane-multiple f32 bank: pad lanes stay neutral and the unpadded
    instances match the generic path at f32 tolerances."""
    n = 5
    dtype = jnp.float32
    bstate, params, rng = _bank(n, dtype, seed=12)
    marker_pos = np.array([5.0, 0.5, -0.5])
    marker_q = np.array([0.5, -0.5, 0.5, -0.5])
    feats = np.stack(
        [
            _project(
                np.asarray(bstate.mu.position[i], np.float64),
                np.asarray(bstate.mu.orientation[i], np.float64),
                marker_pos,
                marker_q,
            )
            + rng.normal(scale=1.0, size=(4, 2))
            for i in range(n)
        ]
    )
    fcovs = np.tile(np.eye(2) * 4.0, (4, 1, 1))
    cov_marker = np.eye(6) * 1e-3

    ref_state, _ = pukf.update_visual_features_bank(
        bstate, params,
        jnp.asarray(feats, dtype), jnp.asarray(fcovs, dtype),
        jnp.asarray(CORNERS, dtype),
        jnp.asarray(marker_pos, dtype), jnp.asarray(marker_q, dtype),
        jnp.asarray(cov_marker, dtype), CAM,
        jnp.asarray(CAM_P, dtype), jnp.asarray(CAM_Q, dtype),
    )
    ls, _ = pmf.update_visual_features_lanes(
        pf.to_lanes(bstate),
        jnp.asarray(feats, dtype), jnp.asarray(fcovs, dtype),
        jnp.asarray(CORNERS, dtype),
        jnp.asarray(marker_pos, dtype), jnp.asarray(marker_q, dtype),
        jnp.asarray(cov_marker, dtype), CAM,
        jnp.asarray(CAM_P, dtype), jnp.asarray(CAM_Q, dtype),
        nb=n, interpret=True,
    )
    out = pf.from_lanes(ls, bstate)
    np.testing.assert_allclose(
        np.asarray(out.mu.position), np.asarray(ref_state.mu.position), atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(out.cov), np.asarray(ref_state.cov), rtol=3e-3, atol=3e-4
    )
    # pad lanes stay FINITE filler (lanes-protocol invariant) — checked on
    # the lower-triangle-valid half the kernel actually writes (the mirrored
    # matrix); the raw upper-triangle region of cov_t is unwritten by design
    assert bool(jnp.isfinite(pf._mirror_half(ls.cov_t)).all())
    assert bool(jnp.isfinite(ls.mu_t).all())

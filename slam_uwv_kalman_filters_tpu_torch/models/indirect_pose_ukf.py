"""IndirectPoseUKF — the error-state pose corrector; counterpart of
``slam_uwv_kalman_filters_tpu/models/indirect_pose_ukf.py`` (reference
``IndirectPoseUKF.hpp`` / ``src/IndirectPoseUKF.cpp``).

A 6-DOF error-state UKF over {position_error ℝ³, orientation_error SO(3)}
that estimates the bias between an external pose reference and visual-marker
sightings. The orientation error decays toward identity with time constant
τ (``IndirectPoseUKF.cpp:6-20``); the corrected pose is reference ∘ error
(``IndirectPoseUKF.cpp:137-142``).

The marker update augments the state with the marker pose (a 12-DOF
temporary filter, ``IndirectPoseUKF.cpp:26-33, 94-135``) with zero
cross-covariance, applies one S²-valued pinhole-bearing update per corner
and marginalizes the marker block back out, so the marker pose's
uncertainty is consumed exactly.

Bank functions take a leading bank axis on every state leaf. A bank on the
card takes the kernels of ``models/indirect_fused.py``: K9 predicts with a
shared τ and (6, 6) process noise, K10 runs the whole marker update. A CPU
bank takes the generic batched path, and so does a banked sweep (Q (B, 6, 6)
or τ (B,)) on any device, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import manifolds as mf
from ..ops import ukf
from ..parallel.bank import tree_map
from ..utils.config import CameraConfiguration
from ..utils.device import resolve_device
from ..utils.validation import check_measurement

__all__ = [
    "PoseErrorState",
    "ERROR_MANIFOLD",
    "PoseErrorStateWithMarker",
    "MARKER_MANIFOLD",
    "IndirectPoseUKFState",
    "IndirectPoseUKFParams",
    "init",
    "predict",
    "predict_bank",
    "update_markers",
    "update_markers_bank",
    "update_pose_reference",
    "corrected_pose",
    "pixel_to_s2",
    "pixel_cov_to_s2",
    "IndirectPoseUKF",
]


class PoseErrorState(NamedTuple):
    """``MTK_BUILD_MANIFOLD(PoseErrorState, …)`` (``IndirectPoseUKF.hpp:19-22``)."""

    position_error: torch.Tensor  # (3,)
    orientation_error: torch.Tensor  # (4,) quaternion


ERROR_MANIFOLD = mf.make_manifold(
    mf.Field("position_error", "vec", 3),
    mf.Field("orientation_error", "so3"),
)  # DOF = 6 → 13 sigma points


class PoseErrorStateWithMarker(NamedTuple):
    """``FilterStateWithMarker`` (``IndirectPoseUKF.cpp:26-30``), flattened:
    the fields of the error state, then the marker pose."""

    position_error: torch.Tensor
    orientation_error: torch.Tensor
    marker_position: torch.Tensor  # (3,)
    marker_orientation: torch.Tensor  # (4,)


MARKER_MANIFOLD = mf.make_manifold(
    mf.Field("position_error", "vec", 3),
    mf.Field("orientation_error", "so3"),
    mf.Field("marker_position", "vec", 3),
    mf.Field("marker_orientation", "so3"),
)  # DOF = 12 → 25 sigma points


class IndirectPoseUKFParams(NamedTuple):
    orientation_error_tau: torch.Tensor  # () [s], or (B,) for a sweep
    process_noise: torch.Tensor  # (6, 6), or (B, 6, 6) for a sweep


class IndirectPoseUKFState(NamedTuple):
    mu: PoseErrorState
    cov: torch.Tensor  # (6, 6)
    pose_ref_position: torch.Tensor  # (3,) body-in-world reference pose
    pose_ref_orientation: torch.Tensor  # (4,)


def init(position_error_std, orientation_error_std, orientation_error_tau: float, initial_position_error=None,
         initial_position_error_std=None, dtype=torch.float64, device=None):
    """Constructor semantics of ``IndirectPoseUKF.cpp:53-78``: the initial
    covariance from the *initial* stds, the process noise from the per-step
    stds. Builds on the card unless ``device`` names another
    (``utils/device.py``)."""
    device = resolve_device(device)
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    pes, oes = t(position_error_std), t(orientation_error_std)
    ipe = torch.zeros(3, dtype=dtype, device=device) if initial_position_error is None else t(initial_position_error)
    ipes = (torch.ones(3, dtype=dtype, device=device) if initial_position_error_std is None
            else t(initial_position_error_std))
    cov = torch.zeros(6, 6, dtype=dtype, device=device)
    cov[:3, :3] = torch.diag(ipes**2)
    cov[3:, 3:] = torch.diag(oes**2)
    q = torch.zeros(6, 6, dtype=dtype, device=device)
    q[:3, :3] = torch.diag(pes**2)
    q[3:, 3:] = torch.diag(oes**2)
    state = IndirectPoseUKFState(
        mu=PoseErrorState(position_error=ipe, orientation_error=mf.quat_identity(dtype, device)),
        cov=cov,
        pose_ref_position=torch.zeros(3, dtype=dtype, device=device),
        pose_ref_orientation=mf.quat_identity(dtype, device),
    )
    return state, IndirectPoseUKFParams(orientation_error_tau=t(orientation_error_tau), process_noise=q)


def _predict_generic(bstate: IndirectPoseUKFState, params: IndirectPoseUKFParams, dt) -> IndirectPoseUKFState:
    """``predictionStepImpl`` (``IndirectPoseUKF.cpp:80-92``) of a bank: the
    orientation block of Q Markov-scaled by 2/(τ·dt) and rotated into the
    error frame, then the whole Q scaled by dt²; the process model decays the
    orientation error through its log (the position error is a random walk).
    τ and Q may carry a bank axis."""
    nb = bstate.cov.shape[0]
    tau = params.orientation_error_tau
    rot = mf.quat_to_matrix(bstate.mu.orientation_error)  # (B, 3, 3)
    q = params.process_noise.expand(nb, 6, 6)
    scale = (2.0 / (tau * dt)).reshape(-1, 1, 1)
    q_orient = rot @ (scale * q[:, 3:, 3:]) @ rot.transpose(-1, -2)
    q = torch.cat([q[:, :3], torch.cat([q[:, 3:, :3], q_orient], -1)], -2)
    q = dt**2 * q
    tau_b = tau[:, None] if tau.ndim == 1 else tau

    def f(chi: PoseErrorState) -> PoseErrorState:
        delta = (-1.0 / tau_b) * mf.quat_log(chi.orientation_error)
        return chi._replace(orientation_error=mf.so3_boxplus(chi.orientation_error, delta, dt))

    mu, cov = ukf.predict(ERROR_MANIFOLD, bstate.mu, bstate.cov, f, q)
    return bstate._replace(mu=mu, cov=cov)


def pixel_to_s2(pixel: torch.Tensor, cam: CameraConfiguration) -> torch.Tensor:
    """Undistorted pixel(s) (..., 2) → S² bearings (..., 3) through the
    pinhole model (``IndirectPoseUKF.cpp:119-121``)."""
    v = torch.stack([(pixel[..., 0] - cam.cx) / cam.fx, (pixel[..., 1] - cam.cy) / cam.fy,
                     torch.ones_like(pixel[..., 0])], dim=-1)
    return mf.s2_normalize(v)


def pixel_cov_to_s2(pixel_cov: torch.Tensor, cam: CameraConfiguration) -> torch.Tensor:
    """Pixel covariance(s) (..., 2, 2) → tangent covariance
    (``IndirectPoseUKF.cpp:122-124``): divided by fx², fy², fx·fy."""
    scale = torch.tensor([[cam.fx * cam.fx, cam.fx * cam.fy], [cam.fx * cam.fy, cam.fy * cam.fy]],
                         dtype=pixel_cov.dtype, device=pixel_cov.device)
    return pixel_cov / scale


def _visual_landmark_measurement(chi: PoseErrorStateWithMarker, feature_pos, cam_q, cam_p, ref_q, ref_p):
    """``measurementVisualLandmark`` (``IndirectPoseUKF.cpp:38-50``): the
    feature → nav → camera frame → S² bearing, with the pose error composed
    between the reference pose and the camera extrinsics."""
    body_q, body_p = mf.affine_mul(ref_q, ref_p, chi.orientation_error, chi.position_error)
    cam_in_nav_q, cam_in_nav_p = mf.affine_mul(body_q, body_p, cam_q, cam_p)
    nav_in_cam_q, nav_in_cam_p = mf.affine_inv(cam_in_nav_q, cam_in_nav_p)
    feature_in_nav = mf.affine_apply(chi.marker_orientation, chi.marker_position, feature_pos)
    feature_in_cam = mf.affine_apply(nav_in_cam_q, nav_in_cam_p, feature_in_nav)
    return mf.s2_normalize(feature_in_cam)


def _check_corners(k: int, n_positions: int, n_covs: int, what: str = "update_markers") -> None:
    """The JAX package's guards: no corner, or counts that disagree."""
    if k == 0:
        raise ValueError(f"{what} needs at least one feature")
    if n_positions != k or n_covs != k:
        raise ValueError(f"{k} marker_features but {n_positions} feature_positions / {n_covs} feature_covs")


def _update_markers_generic(bstate: IndirectPoseUKFState, feats, fcovs, fpos, mpos, mrot, cov_marker, camera,
                            cam_p, cam_q):
    """The marker update of a bank (``IndirectPoseUKF.cpp:94-135``): feats
    (B, K, 2) pixels, fcovs (B, K, 2, 2), fpos (K, 3) in the marker frame,
    the marker pose (B, 3) / (B, 4), cov_marker (6, 6), the camera
    extrinsics (3,) / (4,). Returns the marginalized state and the infos on a
    (B, K) axis."""
    k = feats.shape[1]
    _check_corners(k, fpos.shape[0], fcovs.shape[1])
    aug_mu = PoseErrorStateWithMarker(bstate.mu.position_error, bstate.mu.orientation_error, mpos, mrot)
    aug_cov = ukf.augment_covariance(bstate.cov, cov_marker)
    ref_q, ref_p = bstate.pose_ref_orientation, bstate.pose_ref_position
    infos = []
    for i in range(k):
        z = pixel_to_s2(feats[:, i], camera)
        r = pixel_cov_to_s2(fcovs[:, i], camera)
        h = lambda chi, fp=fpos[i]: _visual_landmark_measurement(chi, fp, cam_q, cam_p, ref_q, ref_p)
        aug_mu, aug_cov, info = ukf.update(MARKER_MANIFOLD, aug_mu, aug_cov, z, h, r, meas_manifold=mf.S2_MANIFOLD)
        infos.append(info)
    # marginalize the marker block back out (IndirectPoseUKF.cpp:134)
    mu = PoseErrorState(position_error=aug_mu.position_error, orientation_error=aug_mu.orientation_error)
    info = ukf.UpdateInfo(*(torch.stack(leaves, dim=1) for leaves in zip(*infos)))
    return bstate._replace(mu=mu, cov=aug_cov[:, :6, :6].contiguous()), info


def _solo(fn, state: IndirectPoseUKFState, *args):
    """Run a bank function on one filter (a bank of one)."""
    out = fn(tree_map(lambda a: a[None], state), *args)
    if isinstance(out, IndirectPoseUKFState):
        return tree_map(lambda a: a[0], out)
    new_state, info = out
    return tree_map(lambda a: a[0], new_state), tree_map(lambda a: a[0], info)


def _as(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def predict(state: IndirectPoseUKFState, params: IndirectPoseUKFParams, dt) -> IndirectPoseUKFState:
    """Prediction of one filter (generic path)."""
    return _solo(_predict_generic, state, params, dt)


def update_markers(state: IndirectPoseUKFState, marker_features, feature_covs, feature_positions, marker_position,
                   marker_orientation, cov_marker_pose, camera: CameraConfiguration, camera_in_body_position,
                   camera_in_body_orientation):
    """Visual-marker update of one filter with state augmentation
    (``IndirectPoseUKF.cpp:94-135``): marker_features (K, 2) pixels,
    feature_covs (K, 2, 2), feature_positions (K, 3) in the marker frame.
    Returns the state and the per-feature ``UpdateInfo`` stacked on a
    leading (K,) axis; K = 0 or mismatched counts raise ``ValueError``."""
    c = state.cov
    feats, fcovs, fpos = _as(marker_features, c), _as(feature_covs, c), _as(feature_positions, c)
    return _solo(_update_markers_generic, state, feats[None], fcovs[None], fpos, _as(marker_position, c)[None],
                 _as(marker_orientation, c)[None], _as(cov_marker_pose, c), camera, _as(camera_in_body_position, c),
                 _as(camera_in_body_orientation, c))


# ---------------------------------------------------------------------------
# bank entry points: K9 and K10 for a bank on the card
# ---------------------------------------------------------------------------


def _fused_route(bstate: IndirectPoseUKFState) -> bool:
    """True for a bank on the card (the kernels), False for a CPU bank
    (generic path); any other device raises."""
    kind = bstate.cov.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no IndirectPoseUKF bank path for device {bstate.cov.device}")
    return kind == "cuda" and bstate.cov.ndim == 3


def predict_bank(bstate: IndirectPoseUKFState, params: IndirectPoseUKFParams, dt) -> IndirectPoseUKFState:
    """Bank prediction: one K9 launch for a bank on the card with a shared τ
    and (6, 6) process noise (the per-instance error-rotated Q and the SO(3)
    mean included); the generic batched path for a CPU bank and for a banked
    sweep (Q (B, 6, 6) or τ (B,)), as the JAX package routes it."""
    banked = params.process_noise.ndim == 3 or params.orientation_error_tau.ndim == 1
    if _fused_route(bstate) and not banked:
        from . import indirect_fused

        return indirect_fused.predict_fused_banked(bstate, params, dt)
    return _predict_generic(bstate, params, dt)


def update_markers_bank(bstate: IndirectPoseUKFState, marker_features, feature_covs, feature_positions,
                        marker_position, marker_orientation, cov_marker_pose, camera: CameraConfiguration,
                        camera_in_body_position, camera_in_body_orientation):
    """Bank visual-marker update. ``marker_features`` / ``feature_covs`` are
    shared (K, …) or per instance (B, K, …), the marker pose shared (3,) /
    (4,) or per instance (B, 3) / (B, 4). On the card the augmentation, the
    K chained S² corner updates and the marginalization are one K10
    launch. Returns the state and the infos on a (B, K) axis."""
    if _fused_route(bstate):
        from . import indirect_fused

        return indirect_fused.update_markers_fused_banked(
            bstate, marker_features, feature_covs, feature_positions, marker_position, marker_orientation,
            cov_marker_pose, camera, camera_in_body_position, camera_in_body_orientation)
    nb, c = bstate.cov.shape[0], bstate.cov
    feats = _as(marker_features, c)
    if feats.ndim == 2:
        feats = feats[None].expand(nb, *feats.shape)
    k = feats.shape[1]
    fcovs = _as(feature_covs, c)
    _check_corners(k, _as(feature_positions, c).shape[0], fcovs.shape[-3] if fcovs.ndim > 2 else k)
    return _update_markers_generic(
        bstate, feats, fcovs.expand(nb, k, 2, 2), _as(feature_positions, c), _as(marker_position, c).expand(nb, 3),
        _as(marker_orientation, c).expand(nb, 4), _as(cov_marker_pose, c), camera, _as(camera_in_body_position, c),
        _as(camera_in_body_orientation, c))


def update_pose_reference(state: IndirectPoseUKFState, position, orientation) -> IndirectPoseUKFState:
    """``updatePoseReference`` (``IndirectPoseUKF.cpp:144-147``); one
    filter or a bank."""
    return state._replace(pose_ref_position=_as(position, state.pose_ref_position),
                          pose_ref_orientation=_as(orientation, state.pose_ref_orientation))


def corrected_pose(state: IndirectPoseUKFState):
    """``getCorrectedPose`` (``IndirectPoseUKF.cpp:137-142``): reference ∘
    error. Returns (orientation, position)."""
    return mf.affine_mul(state.pose_ref_orientation, state.pose_ref_position, state.mu.orientation_error,
                         state.mu.position_error)


# ---------------------------------------------------------------------------
# the reference's class surface (one filter)
# ---------------------------------------------------------------------------


class IndirectPoseUKF:
    """Stateful wrapper with the reference's class surface
    (``IndirectPoseUKF.hpp:29-83``); the math is the functions above."""

    def __init__(self, position_error_std, orientation_error_std, orientation_error_tau, initial_position_error=None,
                 initial_position_error_std=None, dtype=torch.float64, device=None):
        self.state, self.params = init(position_error_std, orientation_error_std, orientation_error_tau,
                                       initial_position_error, initial_position_error_std, dtype=dtype, device=device)

    def prediction_step(self, dt: float) -> None:
        self.state = predict(self.state, self.params, dt)

    def set_process_noise_covariance(self, q) -> None:
        """Raw-Q setter of the filter base class (``setProcessNoiseCovariance``)."""
        self.params = self.params._replace(process_noise=_as(q, self.state.cov))

    def update_pose_reference(self, position, orientation) -> None:
        self.state = update_pose_reference(self.state, position, orientation)

    def integrate_marker_measurement(self, marker_features, feature_covs, feature_positions, marker_position,
                                     marker_orientation, cov_marker_pose, camera: CameraConfiguration,
                                     camera_in_body_position, camera_in_body_orientation) -> ukf.UpdateInfo:
        for i in range(len(marker_features)):
            check_measurement(marker_features[i], feature_covs[i])
        self.state, info = update_markers(self.state, marker_features, feature_covs, feature_positions,
                                          marker_position, marker_orientation, cov_marker_pose, camera,
                                          camera_in_body_position, camera_in_body_orientation)
        return info

    def get_corrected_pose(self):
        return corrected_pose(self.state)

    @property
    def mu(self) -> PoseErrorState:
        return self.state.mu

    @property
    def sigma(self) -> torch.Tensor:
        return self.state.cov

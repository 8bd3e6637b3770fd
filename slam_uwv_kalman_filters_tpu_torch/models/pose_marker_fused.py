"""The PoseUKF visual-marker update in one launch — kernel K11 and its plain
version.

Counterpart of ``slam_uwv_kalman_filters_tpu/models/pose_marker_fused.py``.
On a CUDA tensor :func:`update_visual_features_lanes` launches
``csrc/pose_markers.cu``; on a CPU tensor it runs
:func:`pose_markers_lanes_plain`. Nothing falls back from one to the other.

The update (``src/PoseUKF.cpp:613-654``), per instance:

1. the 59×59 augmented covariance from the valid (row ≥ col) half of the
   lanes covariance, a zero cross block and the shared marker-pose prior
   (``PoseUKF.cpp:623-625``); the augmented mean is the 54 storage rows and
   the marker pose (61 rows);
2. per corner: a fresh equilibrated 59×59 factor (the shared Cholesky core
   in keep mode); the 119 sigma points in the order zero, +columns,
   −columns (delta row k of column j is ±L̃[k, j]·d[k], never stored) through
   the bearing model :func:`_marker_bearing`; the S² Karcher mean of the 119
   bearings (:data:`MEAN_ITERS` fixed iterations seeded at the zero point);
   dZ = bearing ⊟ mean and ν = z ⊟ mean in its basis; S = ½ΣdZdZᵀ + R and
   C = ½·d ⊙ Σⱼ L̃[:, j]·(dZ⁺ⱼ − dZ⁻ⱼ); the 2×2 Cholesky gain with every
   corner accepted (the PoseUKF's marker update has no χ² gate); the
   correction on the flats and ⊞ into both quaternions; the half-triangle
   downdate of the augmented covariance;
3. the marker block marginalized out: the top-left 53×53 valid half and the
   54 mean rows are written.

The plain version sums over the sigma points in PyTorch's order, the kernel
point by point; both differ from the generic path
(``pose_ukf.update_visual_features_bank``) in the S² mean, a fixed 4
iterations where the generic mean iterates to its tolerance, which agree to
rounding (``tests/test_torch_pose_markers.py``).

Lanes layout, bank last: ``cov_t`` (53, 53, B) valid at [c, r ≥ c], ``mu_t``
(54, B) storage rows, ``mk_t`` (7, B) the marker pose's mean [position,
quaternion], ``z_t`` (K, 3, B) unit bearings, ``r_t`` (K, 2, 2, B) tangent
covariances, ``scal`` (43 + 3K): the camera-in-IMU position (3) and
orientation (4), ½(C + Cᵀ) of the marker pose's covariance row-major (36),
then each corner's position in the marker frame. The port does not pad a
bank; a caller that pads gives the true bank as ``nb``, and the pad lanes get
the JAX package's pad corners: bearing (0, 0, 1), R = I and an identity
marker pose.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from ..ops import cuda_lib
from ..ops import ukf
from .bottom_fused import MEAN_ITERS, _s2_basis, _s2_boxminus, _s2_karcher_mean
from .indirect_fused import _check_shapes, corner_operands
from .pose_fused import (STORAGE_DIM, TANGENT_DIM, _lower_half, _qexp, _qmul, _qnorm4, _rot_fwd,
                         _rot_inv, _sigma_columns, from_lanes, to_lanes)

if TYPE_CHECKING:
    from ..utils.config import CameraConfiguration
    from .pose_fused import LanesBankState
    from .pose_ukf import PoseUKFState

__all__ = [
    "AUG_TANGENT",
    "AUG_STORAGE",
    "AUG_NSIG",
    "MEAN_ITERS",
    "marker_operands",
    "update_visual_features_lanes",
    "update_visual_features_fused_banked",
    "pose_markers_lanes_cuda",
    "pose_markers_lanes_plain",
]

AUG_TANGENT = TANGENT_DIM + 6  # 59
AUG_STORAGE = STORAGE_DIM + 7  # 61: + marker position (3) and quaternion (4)
AUG_NSIG = 2 * AUG_TANGENT + 1  # 119
# scalar-operand offsets: camera-in-IMU position (3), orientation (4), the
# marker pose's covariance (36), then 3 per corner
_M_CAM_P = 0
_M_CAM_Q = 3
_M_COV = 7
_M_FEAT = 43


def _marker_bearing(mu, dl, fp, cam_p, cam_q):
    """Predicted S² bearing components of the sigma points whose tangent row
    k is ``dl(k)`` ((P, B) or (1, B)) around the augmented storage mean
    ``mu`` (61 rows of (B,)) — ``measurementVisualLandmark``
    (``PoseUKF.cpp:233-243``): feature → nav → camera frame → unit bearing.
    The norm is floored at the dtype's tiny: identity-covariance pad lanes
    draw ±1 rad sigma deltas that can march the feature through the camera
    origin; real geometry never does."""
    pos = tuple(mu[i] + dl(i) for i in range(3))
    q = _qnorm4(*_qmul(mu[3], mu[4], mu[5], mu[6], *_qexp(dl(3), dl(4), dl(5))))
    mpos = tuple(mu[54 + i] + dl(53 + i) for i in range(3))
    mq = _qnorm4(*_qmul(mu[57], mu[58], mu[59], mu[60], *_qexp(dl(56), dl(57), dl(58))))
    # the camera in nav: (q, pos) ∘ (cam_q, cam_p)
    cam_nav_q = _qnorm4(*_qmul(*q, *cam_q))
    rp = _rot_fwd(q, cam_p)
    cam_nav_p = tuple(pos[i] + rp[i] for i in range(3))
    # the feature in nav (marker pose ∘ fp), then in the camera frame
    fn = _rot_fwd(mq, fp)
    f_cam = _rot_inv(cam_nav_q, tuple(mpos[i] + fn[i] - cam_nav_p[i] for i in range(3)))
    n2 = f_cam[0] * f_cam[0] + f_cam[1] * f_cam[1] + f_cam[2] * f_cam[2]
    inv = 1.0 / torch.sqrt(torch.clamp(n2, min=torch.finfo(n2.dtype).tiny))
    return tuple(inv * c for c in f_cam)


def pose_markers_lanes_plain(cov_t, mu_t, mk_t, z_t, r_t, scal):
    """The marker update in PyTorch, operand for operand what K11 computes.
    Returns (cov_out (53, 53, B) valid half with zeros in the other, mu_out
    (54, B), m2 (K, B), nu_t (K, 2, B))."""
    n, nb = AUG_TANGENT, cov_t.shape[-1]
    cam_p = tuple(scal[_M_CAM_P + i] for i in range(3))
    cam_q = tuple(scal[_M_CAM_Q + i] for i in range(4))
    # the augmented covariance in the lanes convention: (col, row, B), valid
    # at row ≥ col; a_t[53 + i, 53 + j] is the marker covariance's (i, j)
    a_t = torch.zeros(n, n, nb, dtype=cov_t.dtype, device=cov_t.device)
    a_t[:TANGENT_DIM, :TANGENT_DIM] = _lower_half(cov_t)
    a_t[TANGENT_DIM:, TANGENT_DIM:] = scal[_M_COV:_M_FEAT].reshape(6, 6)[..., None]
    mu = list(torch.cat([mu_t, mk_t]).unbind(0))
    m2s, nus = [], []
    for c in range(z_t.shape[0]):
        fp = tuple(scal[_M_FEAT + 3 * c + i] for i in range(3))
        lt, dvec = _sigma_columns(a_t)  # (B, k, j), (B, k)
        cols = lt.permute(2, 1, 0) * dvec.T[None]  # (j, k, B): column j of L at row k
        Zp = _marker_bearing(mu, lambda k: cols[:, k], fp, cam_p, cam_q)
        Zm = _marker_bearing(mu, lambda k: -cols[:, k], fp, cam_p, cam_q)
        zero = torch.zeros_like(mu[0])[None]
        Z0 = _marker_bearing(mu, lambda k: zero, fp, cam_p, cam_q)
        pts = tuple(torch.cat([Z0[a], Zp[a], Zm[a]]) for a in range(3))  # (119, B) each
        z_mean = _s2_karcher_mean(pts)
        basis = _s2_basis(z_mean)
        dz = _s2_boxminus(pts, z_mean, basis)
        nu = _s2_boxminus((z_t[c, 0], z_t[c, 1], z_t[c, 2]), z_mean, basis)
        s00 = 0.5 * (dz[0] * dz[0]).sum(0) + r_t[c, 0, 0]
        s10 = 0.5 * (dz[1] * dz[0]).sum(0) + r_t[c, 1, 0]
        s11 = 0.5 * (dz[1] * dz[1]).sum(0) + r_t[c, 1, 1]
        lt_kj = lt.permute(1, 2, 0)  # (k, j, B)
        C = [0.5 * dvec.T * (lt_kj * (dz[a][1:1 + n] - dz[a][1 + n:])[None]).sum(1) for a in range(2)]  # (59, B)
        # the 2×2 Cholesky gain; every corner is accepted (PoseUKF.cpp:646-648)
        l00 = torch.sqrt(s00)
        i00 = 1.0 / l00
        l10 = s10 * i00
        i11 = 1.0 / torch.sqrt(s11 - l10 * l10)
        w0 = C[0] * i00
        w1 = (C[1] - l10 * w0) * i11
        y0 = nu[0] * i00
        y1 = (nu[1] - l10 * y0) * i11
        m2s.append(y0 * y0 + y1 * y1)
        nus.append(torch.stack(nu))
        corr = w0 * y0 + w1 * y1  # (59, B)
        q = _qnorm4(*_qmul(*mu[3:7], *_qexp(corr[3], corr[4], corr[5])))
        mq = _qnorm4(*_qmul(*mu[57:61], *_qexp(corr[56], corr[57], corr[58])))
        mu = ([mu[i] + corr[i] for i in range(3)] + list(q) + [mu[i] + corr[i - 1] for i in range(7, 54)]
              + [mu[54 + i] + corr[53 + i] for i in range(3)] + list(mq))
        a_t = a_t - (w0[:, None] * w0[None] + w1[:, None] * w1[None])
    # marginalize the marker block (PoseUKF.cpp:651-653)
    return (_lower_half(a_t[:TANGENT_DIM, :TANGENT_DIM]).contiguous(), torch.stack(mu[:STORAGE_DIM]).contiguous(),
            torch.stack(m2s).contiguous(), torch.stack(nus).contiguous())


def pose_markers_lanes_cuda(cov_t, mu_t, mk_t, z_t, r_t, scal):
    """K11 on the card, same operands and outputs as
    :func:`pose_markers_lanes_plain` (the other half of cov_out is left
    unwritten): one warp per instance, no scratch; the corner count is a
    runtime loop of the kernel, with no cap."""
    nb, k = cov_t.shape[-1], z_t.shape[0]
    dev, dtype = cov_t.device, cov_t.dtype
    if k < 1:
        raise ValueError("the marker update kernel needs at least one corner")
    ops = dict(cov_t=cov_t, mu_t=mu_t, mk_t=mk_t, z_t=z_t, r_t=r_t, scal=scal)
    _check_shapes("pose_markers", ops, dict(
        cov_t=(TANGENT_DIM, TANGENT_DIM, nb), mu_t=(STORAGE_DIM, nb), mk_t=(7, nb), z_t=(k, 3, nb),
        r_t=(k, 2, 2, nb), scal=(_M_FEAT + 3 * k,)))
    empty = lambda *shape: torch.empty(shape, dtype=dtype, device=dev)
    cov_out, mu_out, m2, nu_t = empty(TANGENT_DIM, TANGENT_DIM, nb), empty(STORAGE_DIM, nb), empty(k, nb), \
        empty(k, 2, nb)
    cuda_lib.check_lanes("pose_markers", dev, dtype, cov_out=cov_out, **ops)
    cuda_lib.KERNELS["pose_markers"].launch(
        dtype, *(t.data_ptr() for t in (cov_t, mu_t, mk_t, z_t, r_t, scal)), k,
        *(t.data_ptr() for t in (cov_out, mu_out, m2, nu_t)), nb, cuda_lib.stream_ptr(dev))
    return cov_out, mu_out, m2, nu_t


_POSE_MARKERS = cuda_lib.kernel_op(
    "pose_markers",
    "(Tensor cov_t, Tensor mu_t, Tensor mk_t, Tensor z_t, Tensor r_t, Tensor scal) -> (Tensor, Tensor, Tensor, Tensor)",
    lambda *a: pose_markers_lanes_cuda(*a), lambda *a: pose_markers_lanes_plain(*a),
    lambda cov_t, mu_t, mk_t, z_t, r_t, scal: (
        cov_t.new_empty(cov_t.shape), mu_t.new_empty(mu_t.shape), cov_t.new_empty(z_t.shape[0], cov_t.shape[-1]),
        cov_t.new_empty(z_t.shape[0], 2, cov_t.shape[-1])),
)


def _pose_markers_lanes(cov_t, mu_t, mk_t, z_t, r_t, scal):
    cuda_lib.route("update_visual_features_lanes", cov_t)
    return _POSE_MARKERS(cov_t, mu_t, mk_t, z_t, r_t, scal)


# ---------------------------------------------------------------------------
# operands and public entry points
# ---------------------------------------------------------------------------


def marker_operands(lstate: "LanesBankState", marker_features, feature_covs, feature_positions, marker_position,
                    marker_orientation, cov_marker_pose, camera: "CameraConfiguration", camera_in_imu_position,
                    camera_in_imu_orientation, nb: int | None = None):
    """The operands of K11 for :func:`update_visual_features_lanes`'s
    arguments: (nb, (cov_t, mu_t, mk_t, z_t, r_t, scal)). Pixels become S²
    bearings and R / f² here, pad lanes get the JAX package's pad corners
    (``indirect_fused.corner_operands``, which K10 takes too)."""
    nb, ops = corner_operands(lstate.cov_t, marker_features, feature_covs, feature_positions, marker_position,
                              marker_orientation, cov_marker_pose, camera, camera_in_imu_position,
                              camera_in_imu_orientation, nb, "update_visual_features")
    return nb, (lstate.cov_t, lstate.mu_t, *ops)


def update_visual_features_lanes(lstate: "LanesBankState", marker_features, feature_covs, feature_positions,
                                 marker_position, marker_orientation, cov_marker_pose, camera: "CameraConfiguration",
                                 camera_in_imu_position, camera_in_imu_orientation, *, nb: int | None = None):
    """The visual-marker update on kernel-layout state, in one launch:
    ``marker_features`` (K, 2) or (B, K, 2) pixels, ``feature_covs`` (K, 2,
    2) or (B, K, 2, 2), ``feature_positions`` (K, 3) in the marker frame,
    the marker pose's mean (3,) / (4,) or (B, 3) / (B, 4); its (6, 6)
    covariance and the camera shared. ``nb`` is the true bank (default: the
    per-instance features' bank, else every lane). Returns
    ``(LanesBankState, UpdateInfo)`` with the infos on a (B, K) axis, like
    ``pose_ukf.update_visual_features_bank``."""
    nb, ops = marker_operands(lstate, marker_features, feature_covs, feature_positions, marker_position,
                              marker_orientation, cov_marker_pose, camera, camera_in_imu_position,
                              camera_in_imu_orientation, nb)
    cov_t, mu_t, m2, nu_t = _pose_markers_lanes(*ops)
    info = ukf.UpdateInfo(mahalanobis2=m2.T[:nb],
                          accepted=torch.ones(m2.shape[::-1], dtype=torch.bool, device=m2.device)[:nb],
                          innovation=nu_t.permute(2, 0, 1)[:nb])
    return lstate._replace(cov_t=cov_t, mu_t=mu_t), info


def update_visual_features_fused_banked(bstate: "PoseUKFState", marker_features, feature_covs, feature_positions,
                                        marker_position, marker_orientation, cov_marker_pose, camera,
                                        camera_in_imu_position, camera_in_imu_orientation):
    """Bank-first marker update: pack → one K11 launch → unpack."""
    ls, info = update_visual_features_lanes(to_lanes(bstate), marker_features, feature_covs, feature_positions,
                                            marker_position, marker_orientation, cov_marker_pose, camera,
                                            camera_in_imu_position, camera_in_imu_orientation,
                                            nb=bstate.cov.shape[0])
    return from_lanes(ls, bstate), info

"""The IndirectPoseUKF's two kernels — K9, the predict, and K10, the
marker update with state augmentation — and their plain versions.

Counterpart of ``slam_uwv_kalman_filters_tpu/models/indirect_fused.py``. On a
CUDA tensor :func:`predict_lanes` launches ``csrc/indirect_predict.cu`` and
:func:`update_markers_lanes` launches ``csrc/indirect_markers.cu``; on a CPU
tensor they run :func:`indirect_predict_lanes_plain` and
:func:`indirect_markers_lanes_plain`.

K9 (``src/IndirectPoseUKF.cpp:6-20, 80-92``): the 6×6 Cholesky, 13 sigma
points (the ± columns of the unscaled factor), the position a random walk,
the orientation ⊞δ and then τ-decayed by ⊞(−log/τ)·dt, the SO(3) Karcher
mean, and P = ½ΣDDᵀ + dt²·Q on the position and cross blocks plus the
Markov-scaled, error-rotated orientation block (2/(τ·dt))·dt²·R·Q₃₃·Rᵀ.

K10 (``src/IndirectPoseUKF.cpp:26-50, 94-135``): the 12-DOF augmented
covariance (the filter block ⊕ the marker pose's, zero cross-covariance),
then per corner a fresh 12×12 factor, 25 sigma points through the pinhole
bearing model, the S² Karcher mean of the bearings, S = ½ΣdZdZᵀ + R,
C = ½ΣδdZᵀ and the Kalman tail with every corner accepted, the correction
⊞ into both quaternions and both positions; finally the 6×6 block is
marginalized out.

Both versions compute the same arithmetic (the plain versions sum over the
sigma points in PyTorch's order, the kernels point by point), which differs
from the generic path (``models/indirect_pose_ukf.py``) in the means: the SO(3) and S² means
run a fixed ``MEAN_ITERS`` = 4 iterations seeded from sigma point 0 (the
generic mean iterates to its tolerance), and the predicted position mean is
pos + Σδ/13. The sigma set is ±symmetric about point 0, so the first
correction is nearly exact and the two paths agree to rounding at float64
(``tests/test_torch_indirect_pose_ukf.py``).

Lanes layout, bank last: ``cov_t`` (6, 6, B) in (col, row) order (the lower
half is read, both halves are written), ``mu_t`` (7, B) [position error
xyz, error quaternion wxyz], ``ref_t`` (7, B) the pose reference [position,
quaternion]. The port does not pad the bank; :func:`to_lanes` pads on
request with the JAX package's convention (identity covariance, copies of
instance 0), and the marker update's pad corners are the JAX package's:
bearing (0, 0, 1), R = I and an identity marker pose.
"""

from __future__ import annotations

from typing import NamedTuple, TYPE_CHECKING

import torch

from ..ops import cuda_lib
from ..ops import ukf
from ..ops.linalg_small import _scalar_cholesky_factors
from ..utils.memo import last_operands
from .bottom_fused import _s2_basis, _s2_boxminus, _s2_karcher_mean
from .pose_fused import _qexp, _qlog, _qmul
from .velocity_fused import _grid, _kalman_tail

if TYPE_CHECKING:
    from ..utils.config import CameraConfiguration
    from .indirect_pose_ukf import IndirectPoseUKFParams, IndirectPoseUKFState

__all__ = [
    "MEAN_ITERS",
    "IndirectLanesState",
    "to_lanes",
    "from_lanes",
    "predict_scalars",
    "marker_operands",
    "predict_lanes",
    "update_markers_lanes",
    "predict_fused_banked",
    "update_markers_fused_banked",
    "indirect_predict_lanes_cuda",
    "indirect_predict_lanes_plain",
    "indirect_markers_lanes_cuda",
    "indirect_markers_lanes_plain",
]

DOF = 6  # position_error (3) + orientation_error (SO(3), 3 DOF)
NSIG = 2 * DOF + 1  # 13
AUG_DOF = 12  # + the marker pose (IndirectPoseUKF.cpp:26-30)
AUG_NSIG = 2 * AUG_DOF + 1  # 25
MEAN_ITERS = 4  # fixed Karcher iterations (kIndMeanIters)

# the predict's scalars: dt, τ, then ½(Q + Qᵀ) row-major
_S_DT = 0
_S_TAU = 1
_S_Q = 2
_NSCAL_P = 38
# the marker update's scalars: camera-in-body position (3) and orientation
# (4), ½(C + Cᵀ) of the marker pose's covariance (36), then 3 per corner
_M_CAM_P = 0
_M_CAM_Q = 3
_M_COV = 7
_M_FEAT = 43


class IndirectLanesState(NamedTuple):
    """IndirectPoseUKF bank in kernel layout."""

    cov_t: torch.Tensor  # (6, 6, B) covariance, (col, row, B)
    mu_t: torch.Tensor  # (7, B) position error xyz, error quaternion wxyz
    ref_t: torch.Tensor  # (7, B) pose reference: position xyz, quaternion wxyz


def to_lanes(state: "IndirectPoseUKFState", lanes: int | None = None) -> IndirectLanesState:
    """Bank-first state → kernel layout; ``lanes`` > bank pads with identity
    covariances and copies of instance 0."""
    nb = state.cov.shape[0]
    pad = 0 if lanes is None else lanes - nb
    if pad < 0:
        raise ValueError(f"lanes={lanes} is narrower than the bank ({nb})")
    cov = state.cov
    mu = torch.cat([state.mu.position_error, state.mu.orientation_error], dim=-1)
    ref = torch.cat([state.pose_ref_position, state.pose_ref_orientation], dim=-1)
    if pad:
        cov = torch.cat([cov, torch.eye(DOF, dtype=cov.dtype, device=cov.device).expand(pad, DOF, DOF)])
        tile = lambda a: torch.cat([a, a[:1].expand(pad, a.shape[1])])
        mu, ref = tile(mu), tile(ref)
    return IndirectLanesState(cov_t=cov.permute(2, 1, 0).contiguous(), mu_t=mu.T.contiguous(),
                              ref_t=ref.T.contiguous())


def from_lanes(lstate: IndirectLanesState, like: "IndirectPoseUKFState") -> "IndirectPoseUKFState":
    """Kernel layout → bank-first state shaped like ``like`` (pad lanes
    dropped)."""
    nb = like.cov.shape[0]
    mu, ref = lstate.mu_t.T[:nb], lstate.ref_t.T[:nb]
    return like._replace(
        mu=like.mu._replace(position_error=mu[:, 0:3], orientation_error=mu[:, 3:7]),
        cov=lstate.cov_t.permute(2, 1, 0)[:nb],
        pose_ref_position=ref[:, 0:3],
        pose_ref_orientation=ref[:, 3:7],
    )


@last_operands
def predict_scalars(params: "IndirectPoseUKFParams", dt, dtype) -> torch.Tensor:
    """K9's 38 scalars on the parameters' device: dt, τ and ½(Q + Qᵀ)
    row-major. Built once for each parameter set, dt and dtype and kept for
    the next call (:func:`~..utils.memo.last_operands`); a banked τ or Q
    raises (a sweep runs on the generic path)."""
    q, tau = params.process_noise, params.orientation_error_tau
    if q.shape != (DOF, DOF) or tau.ndim != 0:
        raise ValueError(f"the IndirectPoseUKF predict kernel takes one shared τ and (6, 6) process noise, got "
                         f"τ {tuple(tau.shape)} and Q {tuple(q.shape)}; a banked sweep runs on the generic path "
                         "(indirect_pose_ukf.predict_bank)")
    q = q.to(dtype)
    dt = torch.full((1,), float(dt), dtype=dtype, device=q.device)
    return torch.cat([dt, tau.to(dtype).reshape(1), (0.5 * (q + q.T)).reshape(36)]).contiguous()


# ---------------------------------------------------------------------------
# the plain versions: each quantity a (B,) lane vector, or (N, B) over the
# sigma points, as the kernels' thread
# ---------------------------------------------------------------------------


def _qconj(q):
    return (q[0], -q[1], -q[2], -q[3])


def _qrot(q, v):
    """R(q)·v, the expanded Rodrigues form v + w·t + u × t, t = 2·u × v."""
    u = (q[1], q[2], q[3])
    t = (2.0 * (u[1] * v[2] - u[2] * v[1]), 2.0 * (u[2] * v[0] - u[0] * v[2]), 2.0 * (u[0] * v[1] - u[1] * v[0]))
    ut = (u[1] * t[2] - u[2] * t[1], u[2] * t[0] - u[0] * t[2], u[0] * t[1] - u[1] * t[0])
    return tuple(v[i] + q[0] * t[i] + ut[i] for i in range(3))


def _so3_boxplus(q, d, scale):
    """q ⊞ (scale·d), renormalized by 1/sqrt."""
    y = _qmul(*q, *_qexp(d[0] * scale, d[1] * scale, d[2] * scale))
    inv = 1.0 / torch.sqrt(y[0] * y[0] + y[1] * y[1] + y[2] * y[2] + y[3] * y[3])
    return tuple(inv * c for c in y)


def _so3_boxminus(a, b):
    """a ⊟ b = Log(b⁻¹ ⊗ a)."""
    return _qlog(*_qmul(*_qconj(b), *a))


def _so3_karcher_mean(pts):
    """Fixed-iteration mean of the (N, B) quaternion components ``pts``,
    seeded from point 0."""
    m = tuple(p[0] for p in pts)
    inv_n = 1.0 / pts[0].shape[0]
    for _ in range(MEAN_ITERS):
        d = _so3_boxminus(pts, m)
        m = _so3_boxplus(m, tuple(c.sum(0) * inv_n for c in d), 1.0)
    return m


def _rot_matrix(q):
    w, x, y, z = q
    return [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]


def _deltas(P):
    """The (2n+1, B) sigma deltas of each tangent row of the n×n grid P:
    point 0 zero, 2j+1 / 2j+2 the ±j-th column of its Crout factor."""
    n = len(P)
    L = _scalar_cholesky_factors(_grid(P))
    zero = torch.zeros_like(L[0][0])
    return [torch.stack([zero] + [v for j in range(n) for v in ((L[i][j], -L[i][j]) if j <= i else (zero, zero))])
            for i in range(n)]


def _lower(cov_t, n):
    """The n×n grid of a (n, n, B) lanes covariance from its lower half."""
    return [[cov_t[min(i, j), max(i, j)] for j in range(n)] for i in range(n)]


def _cov_out(P, n):
    return torch.stack([torch.stack([P[i][j] for i in range(n)]) for j in range(n)]).contiguous()


def indirect_predict_lanes_plain(cov_t, mu_t, scal):
    """The predict in PyTorch, operand for operand what K9 computes:
    ``scal`` the 38 scalars of :func:`predict_scalars`. Returns (cov_out
    (6, 6, B), mu_out (7, B))."""
    s = lambda i: scal[i]
    dt, tau = s(_S_DT), s(_S_TAU)
    q33 = [[s(_S_Q + 6 * (3 + i) + 3 + j) for j in range(3)] for i in range(3)]
    pos = [mu_t[i] for i in range(3)]
    qm = tuple(mu_t[3 + i] for i in range(4))
    drow = _deltas(_lower(cov_t, DOF))
    qs = _so3_boxplus(qm, (drow[3], drow[4], drow[5]), 1.0)
    ntau = -1.0 / tau
    qs2 = _so3_boxplus(qs, tuple(ntau * c for c in _qlog(*qs)), dt)
    mean_q = _so3_karcher_mean(qs2)
    dq = _so3_boxminus(qs2, mean_q)
    D = [drow[0], drow[1], drow[2], *dq]
    # Q: the orientation block rotated by R(error), Markov-scaled 2/(τ·dt),
    # then all of it dt² (IndirectPoseUKF.cpp:80-92)
    R = _rot_matrix(qm)
    mscale = 2.0 / (tau * dt) * dt * dt
    Rq = [[sum(R[i][k] * q33[k][j] for k in range(3)) for j in range(3)] for i in range(3)]
    Qo = [[mscale * sum(Rq[i][k] * R[j][k] for k in range(3)) for j in range(3)] for i in range(3)]
    dt2 = dt * dt
    P = [[None] * DOF for _ in range(DOF)]
    for i in range(DOF):
        for j in range(i + 1):
            q = Qo[i - 3][j - 3] if j >= 3 else dt2 * s(_S_Q + 6 * i + j)
            P[i][j] = P[j][i] = 0.5 * (D[i] * D[j]).sum(0) + q
    mpos = [pos[i] + drow[i].sum(0) * (1.0 / NSIG) for i in range(3)]
    return _cov_out(P, DOF), torch.stack([*mpos, *mean_q]).contiguous()


def indirect_markers_lanes_plain(cov_t, mu_t, ref_t, mk_t, z_t, r_t, scal):
    """The marker update in PyTorch, operand for operand what K10 computes:
    ``mk_t`` (7, B) the marker pose, ``z_t`` (K, 3, B) the corners' unit
    bearings, ``r_t`` (K, 2, 2, B) their tangent covariances, ``scal`` the
    43 + 3K scalars of :func:`marker_operands`. Returns (cov_out (6, 6, B),
    mu_out (7, B), m2 (K, B), nu_t (K, 2, B))."""
    s = lambda i: scal[i]
    cam_p = tuple(s(_M_CAM_P + i) for i in range(3))
    cam_q = tuple(s(_M_CAM_Q + i) for i in range(4))
    ref_p, ref_q = tuple(ref_t[i] for i in range(3)), tuple(ref_t[3 + i] for i in range(4))
    pos, qe = [mu_t[i] for i in range(3)], tuple(mu_t[3 + i] for i in range(4))
    mpos, mq = [mk_t[i] for i in range(3)], tuple(mk_t[3 + i] for i in range(4))
    zero = torch.zeros_like(pos[0])
    P = [[zero] * AUG_DOF for _ in range(AUG_DOF)]
    for i in range(DOF):
        for j in range(DOF):
            P[i][j] = cov_t[min(i, j), max(i, j)]
            P[DOF + i][DOF + j] = s(_M_COV + 6 * max(i, j) + min(i, j)) + zero
    m2s, nus = [], []
    for c in range(z_t.shape[0]):
        fp = tuple(s(_M_FEAT + 3 * c + i) for i in range(3))
        drow = _deltas(P)
        sp = [pos[i] + drow[i] for i in range(3)]
        sq = _so3_boxplus(qe, drow[3:6], 1.0)
        smp = [mpos[i] + drow[6 + i] for i in range(3)]
        smq = _so3_boxplus(mq, drow[9:12], 1.0)
        # measurementVisualLandmark (IndirectPoseUKF.cpp:38-50)
        body_q = _qmul(*ref_q, *sq)
        body_p = [a + b for a, b in zip(_qrot(ref_q, sp), ref_p)]
        cam_nav_q = _qmul(*body_q, *cam_q)
        cam_nav_p = [a + b for a, b in zip(_qrot(body_q, cam_p), body_p)]
        f_nav = [a + b for a, b in zip(_qrot(smq, fp), smp)]
        f_cam = _qrot(_qconj(cam_nav_q), [a - b for a, b in zip(f_nav, cam_nav_p)])
        inv_n = 1.0 / torch.sqrt(f_cam[0] * f_cam[0] + f_cam[1] * f_cam[1] + f_cam[2] * f_cam[2])
        bear = tuple(inv_n * v for v in f_cam)
        z_mean = _s2_karcher_mean(bear)
        basis = _s2_basis(z_mean)
        dz = _s2_boxminus(bear, z_mean, basis)
        nu = list(_s2_boxminus((z_t[c, 0], z_t[c, 1], z_t[c, 2]), z_mean, basis))
        S = [[0.5 * (dz[a] * dz[b]).sum(0) + r_t[c, a, b] for b in range(2)] for a in range(2)]
        C = [[0.5 * (drow[i] * dz[a]).sum(0) for a in range(2)] for i in range(AUG_DOF)]
        # every corner is accepted (IndirectPoseUKF.cpp:131): threshold −1
        corr, P, m2, _ = _kalman_tail(P, S, C, nu, -1.0)
        pos = [pos[i] + corr[i] for i in range(3)]
        qe = _so3_boxplus(qe, corr[3:6], 1.0)
        mpos = [mpos[i] + corr[6 + i] for i in range(3)]
        mq = _so3_boxplus(mq, corr[9:12], 1.0)
        m2s.append(m2)
        nus.append(torch.stack(nu))
    # marginalize the marker block back out (IndirectPoseUKF.cpp:134)
    return (_cov_out([row[:DOF] for row in P[:DOF]], DOF), torch.stack([*pos, *qe]).contiguous(),
            torch.stack(m2s).contiguous(), torch.stack(nus).contiguous())


# ---------------------------------------------------------------------------
# the kernels' wrappers and the dispatch by device
# ---------------------------------------------------------------------------


def _check_shapes(name: str, ops: dict, shapes: dict) -> None:
    for key, shape in shapes.items():
        if tuple(ops[key].shape) != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(ops[key].shape)}, expected {shape}")


def indirect_predict_lanes_cuda(cov_t, mu_t, scal):
    """K9 on the card, same operands and outputs as
    :func:`indirect_predict_lanes_plain`."""
    nb = cov_t.shape[-1]
    dev, dtype = cov_t.device, cov_t.dtype
    ops = dict(cov_t=cov_t, mu_t=mu_t, scal=scal)
    _check_shapes("indirect_predict", ops, dict(cov_t=(DOF, DOF, nb), mu_t=(DOF + 1, nb), scal=(_NSCAL_P,)))
    cov_out = torch.empty(DOF, DOF, nb, dtype=dtype, device=dev)
    mu_out = torch.empty(DOF + 1, nb, dtype=dtype, device=dev)
    cuda_lib.check_lanes("indirect_predict", dev, dtype, cov_out=cov_out, **ops)
    cuda_lib.KERNELS["indirect_predict"].launch(
        dtype, cov_t.data_ptr(), mu_t.data_ptr(), scal.data_ptr(), cov_out.data_ptr(), mu_out.data_ptr(), nb,
        cuda_lib.stream_ptr(dev))
    return cov_out, mu_out


def indirect_markers_lanes_cuda(cov_t, mu_t, ref_t, mk_t, z_t, r_t, scal):
    """K10 on the card, same operands and outputs as
    :func:`indirect_markers_lanes_plain`; the corner count is a runtime
    loop of the kernel, with no cap."""
    nb, k = cov_t.shape[-1], z_t.shape[0]
    dev, dtype = cov_t.device, cov_t.dtype
    if k < 1:
        raise ValueError("the marker update kernel needs at least one corner")
    ops = dict(cov_t=cov_t, mu_t=mu_t, ref_t=ref_t, mk_t=mk_t, z_t=z_t, r_t=r_t, scal=scal)
    _check_shapes("indirect_markers", ops, dict(
        cov_t=(DOF, DOF, nb), mu_t=(DOF + 1, nb), ref_t=(DOF + 1, nb), mk_t=(DOF + 1, nb), z_t=(k, 3, nb),
        r_t=(k, 2, 2, nb), scal=(_M_FEAT + 3 * k,)))
    empty = lambda *shape: torch.empty(shape, dtype=dtype, device=dev)
    cov_out, mu_out, m2, nu_t = empty(DOF, DOF, nb), empty(DOF + 1, nb), empty(k, nb), empty(k, 2, nb)
    cuda_lib.check_lanes("indirect_markers", dev, dtype, cov_out=cov_out, **ops)
    cuda_lib.KERNELS["indirect_markers"].launch(
        dtype, *(t.data_ptr() for t in (cov_t, mu_t, ref_t, mk_t, z_t, r_t, scal)), k,
        *(t.data_ptr() for t in (cov_out, mu_out, m2, nu_t)), nb, cuda_lib.stream_ptr(dev))
    return cov_out, mu_out, m2, nu_t


_INDIRECT_PREDICT = cuda_lib.kernel_op(
    "indirect_predict", "(Tensor cov_t, Tensor mu_t, Tensor scal) -> (Tensor, Tensor)",
    lambda *a: indirect_predict_lanes_cuda(*a), lambda *a: indirect_predict_lanes_plain(*a),
    lambda cov_t, mu_t, scal: (cov_t.new_empty(cov_t.shape), mu_t.new_empty(mu_t.shape)),
)
_INDIRECT_MARKERS = cuda_lib.kernel_op(
    "indirect_markers",
    "(Tensor cov_t, Tensor mu_t, Tensor ref_t, Tensor mk_t, Tensor z_t, Tensor r_t, Tensor scal)"
    " -> (Tensor, Tensor, Tensor, Tensor)",
    lambda *a: indirect_markers_lanes_cuda(*a), lambda *a: indirect_markers_lanes_plain(*a),
    lambda cov_t, mu_t, ref_t, mk_t, z_t, r_t, scal: (
        cov_t.new_empty(cov_t.shape), mu_t.new_empty(mu_t.shape), cov_t.new_empty(z_t.shape[0], cov_t.shape[-1]),
        cov_t.new_empty(z_t.shape[0], 2, cov_t.shape[-1])),
)


def _indirect_predict_lanes(cov_t, mu_t, scal):
    cuda_lib.route("indirect predict_lanes", cov_t)
    return _INDIRECT_PREDICT(cov_t, mu_t, scal)


def _indirect_markers_lanes(cov_t, mu_t, ref_t, mk_t, z_t, r_t, scal):
    cuda_lib.route("indirect update_markers_lanes", cov_t)
    return _INDIRECT_MARKERS(cov_t, mu_t, ref_t, mk_t, z_t, r_t, scal)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def predict_lanes(lstate: IndirectLanesState, params: "IndirectPoseUKFParams", dt) -> IndirectLanesState:
    """The prediction (``IndirectPoseUKF::predictionStepImpl``) on
    kernel-layout state, with one shared τ and (6, 6) process noise."""
    cov_t, mu_t = _indirect_predict_lanes(lstate.cov_t, lstate.mu_t, predict_scalars(params, dt, lstate.cov_t.dtype))
    return lstate._replace(cov_t=cov_t, mu_t=mu_t)


def corner_operands(cov_t, marker_features, feature_covs, feature_positions, marker_position, marker_orientation,
                    cov_marker_pose, camera: "CameraConfiguration", camera_position, camera_orientation,
                    nb: int | None = None, what: str = "update_markers"):
    """The marker operands that K10 and K11 share, for a bank in ``cov_t``'s
    lanes, dtype and device: (nb, (mk_t, z_t, r_t, scal)). Pixels become S²
    bearings and tangent covariances here (``pixel_to_s2`` /
    ``pixel_cov_to_s2``); pad lanes get the JAX package's pad corners; K = 0
    or mismatched counts raise ``ValueError`` naming ``what``."""
    from .indirect_pose_ukf import _check_corners, pixel_cov_to_s2, pixel_to_s2

    dtype, dev = cov_t.dtype, cov_t.device
    nb_pad = cov_t.shape[-1]
    tensor = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    feats = tensor(marker_features)
    per_instance = feats.ndim == 3
    if not per_instance:
        feats = feats[None]
    k = feats.shape[1]
    fpos = tensor(feature_positions).reshape(-1, 3)
    fcovs = tensor(feature_covs)
    _check_corners(k, fpos.shape[0], fcovs.shape[-3] if fcovs.ndim > 2 else k, what)  # one (2, 2) serves every corner
    if nb is None:
        # per-instance features carry the true bank; shared ones leave it
        # at every lane, which is right only for an unpadded bank
        nb = feats.shape[0] if per_instance else nb_pad
    if nb > nb_pad or (per_instance and feats.shape[0] != nb):
        raise ValueError(f"marker features for a bank of {feats.shape[0]} on {nb} instances in {nb_pad} lanes")
    z = pixel_to_s2(feats, camera).expand(nb, k, 3)
    r = pixel_cov_to_s2(fcovs, camera).expand(nb, k, 2, 2)
    mk = torch.cat([tensor(marker_position).expand(nb, 3), tensor(marker_orientation).expand(nb, 4)], dim=-1)
    pad = nb_pad - nb
    if pad:
        zfill = torch.zeros(pad, k, 3, dtype=dtype, device=dev)
        zfill[..., 2] = 1.0
        mkfill = torch.zeros(pad, 7, dtype=dtype, device=dev)
        mkfill[:, 3] = 1.0
        z = torch.cat([z, zfill])
        r = torch.cat([r, torch.eye(2, dtype=dtype, device=dev).expand(pad, k, 2, 2)])
        mk = torch.cat([mk, mkfill])
    cm = tensor(cov_marker_pose)
    scal = torch.cat([tensor(camera_position).reshape(3), tensor(camera_orientation).reshape(4),
                      (0.5 * (cm + cm.T)).reshape(36), fpos.reshape(3 * k)]).contiguous()
    return nb, (mk.T.contiguous(), z.permute(1, 2, 0).contiguous(), r.permute(1, 2, 3, 0).contiguous(), scal)


def marker_operands(lstate: IndirectLanesState, marker_features, feature_covs, feature_positions, marker_position,
                    marker_orientation, cov_marker_pose, camera: "CameraConfiguration", camera_in_body_position,
                    camera_in_body_orientation, nb: int | None = None):
    """The operands of K10 for :func:`update_markers_lanes`'s arguments:
    (nb, (cov_t, mu_t, ref_t, mk_t, z_t, r_t, scal)); see
    :func:`corner_operands`."""
    nb, ops = corner_operands(lstate.cov_t, marker_features, feature_covs, feature_positions, marker_position,
                              marker_orientation, cov_marker_pose, camera, camera_in_body_position,
                              camera_in_body_orientation, nb)
    return nb, (lstate.cov_t, lstate.mu_t, lstate.ref_t, *ops)


def update_markers_lanes(lstate: IndirectLanesState, marker_features, feature_covs, feature_positions,
                         marker_position, marker_orientation, cov_marker_pose, camera: "CameraConfiguration",
                         camera_in_body_position, camera_in_body_orientation, *, nb: int | None = None):
    """The visual-marker update on kernel-layout state, in one launch:
    ``marker_features`` (K, 2) or (B, K, 2) pixels, ``feature_covs`` (K, 2,
    2) or (B, K, 2, 2), ``feature_positions`` (K, 3) in the marker frame,
    the marker pose (3,) / (4,) or (B, 3) / (B, 4), ``cov_marker_pose`` (6,
    6) and the camera extrinsics shared. ``nb`` is the true bank (default:
    the per-instance features' bank, else every lane). Returns
    ``(IndirectLanesState, UpdateInfo)`` with the infos on a (B, K) axis,
    like the generic ``update_markers_bank``."""
    nb, ops = marker_operands(lstate, marker_features, feature_covs, feature_positions, marker_position,
                              marker_orientation, cov_marker_pose, camera, camera_in_body_position,
                              camera_in_body_orientation, nb)
    cov_t, mu_t, m2, nu_t = _indirect_markers_lanes(*ops)
    info = ukf.UpdateInfo(mahalanobis2=m2.T[:nb], accepted=torch.ones(m2.shape[::-1], dtype=torch.bool,
                                                                        device=m2.device)[:nb],
                          innovation=nu_t.permute(2, 0, 1)[:nb])
    return lstate._replace(cov_t=cov_t, mu_t=mu_t), info


def predict_fused_banked(bstate: "IndirectPoseUKFState", params: "IndirectPoseUKFParams", dt) -> "IndirectPoseUKFState":
    """Bank-first prediction: pack → one launch → unpack."""
    return from_lanes(predict_lanes(to_lanes(bstate), params, dt), bstate)


def update_markers_fused_banked(bstate: "IndirectPoseUKFState", marker_features, feature_covs, feature_positions,
                                marker_position, marker_orientation, cov_marker_pose, camera, camera_in_body_position,
                                camera_in_body_orientation):
    """Bank-first marker update: pack → one launch → unpack."""
    ls, info = update_markers_lanes(to_lanes(bstate), marker_features, feature_covs, feature_positions,
                                    marker_position, marker_orientation, cov_marker_pose, camera,
                                    camera_in_body_position, camera_in_body_orientation, nb=bstate.cov.shape[0])
    return from_lanes(ls, bstate), info

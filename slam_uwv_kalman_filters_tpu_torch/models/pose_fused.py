"""Fused PoseUKF prediction — kernel K2 and its plain version.

Counterpart of ``slam_uwv_kalman_filters_tpu/models/pose_fused.py``: the
whole 53-DOF prediction in one launch —
equilibrated Cholesky → ±sigma deltas, boxplus, the process model (IMU
mechanization with earth-rate compensation, first-order-Markov decays), the
quaternion Karcher mean with a fixed :data:`MEAN_ITERS`, the deviations, and
the half-triangle reconstruct ½ΣDDᵀ + Q with Q assembled per instance. On a
CUDA tensor :func:`predict_lanes` launches ``csrc/pose_predict.cu``; on a CPU
tensor it runs :func:`predict_lanes_plain`.

Two parameter modes, as in JAX: *shared* (one parameter set; the Markov
vectors, Q and the scalars are broadcast to every instance) and *full*
(a banked Monte-Carlo set: per-lane Markov vectors, per-lane dt²-scaled Q and
a (12, B) ``aux_t`` of per-lane anchor, orientation noise and current
inflation, prepacked once by :func:`banked_predict_operands`). JAX's third,
raw-banked mode adds Q outside the kernel; its only caller,
``predict_fused_banked``, takes the full mode here.

Lanes layout, as in the JAX package (the bank axis is minor, so neighbouring
threads read neighbouring addresses): covariance ``cov_t`` (53, 53, B) in
(col, row, bank) order, mean ``mu_t`` (54, B) in storage rows, rotation
rate ``rr_t`` (3, B). The port does not pad the bank: one thread per
instance needs no 128-lane tiles.

``cov_t`` is valid only at ``cov_t[c, r]`` with r ≥ c between launches: the
predict writes only that half, every kernel reads only that half, and
:func:`from_lanes` mirrors it back to a symmetric matrix.

State storage rows (54) against tangent rows (53):

====  ==========================  ============
rows  field                       tangent rows
====  ==========================  ============
0:3   position                    0:3
3:7   orientation quaternion      3:6
7:10  velocity                    6:9
10:13 acceleration                9:12
13:16 bias_gyro                   12:15
16:19 bias_acc                    15:18
19:20 gravity                     18:19
20:29 inertia (col-major)         19:28
29:38 lin_damping (col-major)     28:37
38:47 quad_damping (col-major)    37:46
47:49 water_velocity              46:48
49:51 water_velocity_below        48:50
51:53 bias_adcp                   50:52
53:54 water_density               52:53
====  ==========================  ============
"""

from __future__ import annotations

from typing import NamedTuple, TYPE_CHECKING

import torch

from ..ops import cuda_lib
from ..ops import geodesy as geo
from ..ops.kernels import _mirror_half, equilibrated_cholesky
from ..utils.memo import last_operands

if TYPE_CHECKING:
    from .pose_ukf import PoseUKFParams, PoseUKFState

__all__ = [
    "STORAGE_DIM",
    "TANGENT_DIM",
    "NSIG",
    "MEAN_ITERS",
    "BankedPredictOperands",
    "LanesBankState",
    "banked_predict_operands",
    "to_lanes",
    "from_lanes",
    "set_rotation_rate_lanes",
    "predict_lanes",
    "predict_lanes_cuda",
    "predict_lanes_plain",
    "predict_fused_banked",
]

STORAGE_DIM = 54  # 53 tangent DOF + 1 (the quaternion stores 4 for 3 DOF)
TANGENT_DIM = 53
NSIG = 2 * TANGENT_DIM + 1  # 107
# Fixed quaternion-mean iterations: the ±symmetric sigma set makes the first
# Karcher correction nearly exact, so 4 carry ≥2 iterations of slack;
# converged iterations are fixed points.
MEAN_ITERS = 4

# scalar-operand indices of the (14, 1) ``scal`` block
_S_DT = 0
_S_LAT0 = 1
_S_MRADINV = 2
_S_EARTHW = 3
_S_WVQ = 4  # water_velocity_scale · dt³
_S_QROT = 5  # 5:14 — dt²·(orientation block of Q), row-major
_NSCAL = 14
# rows of the full mode's (12, B) per-lane ``aux_t`` block
_A_LAT0 = 0
_A_MRADINV = 1
_A_QROT = 2  # 2:11 — dt²·(orientation block of Q), row-major
_A_WVQ = 11  # water_velocity_scale · dt³
_NAUX = 12


# ---------------------------------------------------------------------------
# componentwise quaternion helpers (the plain twins of csrc/common.cuh)
# ---------------------------------------------------------------------------


def _qmul(aw, ax, ay, az, bw, bx, by, bz):
    return (
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    )


def _qexp(vx, vy, vz):
    theta2 = vx * vx + vy * vy + vz * vz
    theta = torch.sqrt(theta2)
    small = theta2 < 1e-12
    safe = torch.where(small, torch.ones_like(theta), theta)
    sinc = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(0.5 * safe) / safe)
    return torch.cos(0.5 * theta), sinc * vx, sinc * vy, sinc * vz


def _qlog(w, x, y, z):
    neg = w < 0.0
    w, x, y, z = (torch.where(neg, -c, c) for c in (w, x, y, z))
    w = torch.clamp(w, -1.0, 1.0)
    n2 = x * x + y * y + z * z
    n = torch.sqrt(n2)
    theta = 2.0 * torch.atan2(n, w)
    small = n2 < 1e-24
    safe_n = torch.where(small, torch.ones_like(n), n)
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-6), theta / safe_n)
    return scale * x, scale * y, scale * z


def _qnorm4(w, x, y, z):
    inv = torch.rsqrt(w * w + x * x + y * y + z * z)
    return w * inv, x * inv, y * inv, z * inv


def _rot_inv(q, v):
    """R(q)⁻¹·v, componentwise Rodrigues."""
    qw, qx, qy, qz = q
    vx, vy, vz = v
    tx = 2.0 * (qz * vy - qy * vz)
    ty = 2.0 * (qx * vz - qz * vx)
    tz = 2.0 * (qy * vx - qx * vy)
    return (
        vx + qw * tx + (qz * ty - qy * tz),
        vy + qw * ty + (qx * tz - qz * tx),
        vz + qw * tz + (qy * tx - qx * ty),
    )


def _rot_fwd(q, v):
    """R(q)·v, componentwise Rodrigues."""
    qw, qx, qy, qz = q
    vx, vy, vz = v
    tx = 2.0 * (qy * vz - qz * vy)
    ty = 2.0 * (qz * vx - qx * vz)
    tz = 2.0 * (qx * vy - qy * vx)
    return (
        vx + qw * tx + (qy * tz - qz * ty),
        vy + qw * ty + (qz * tx - qx * tz),
        vz + qw * tz + (qx * ty - qy * tx),
    )


def _cross(u, t):
    return (u[1] * t[2] - u[2] * t[1], u[2] * t[0] - u[0] * t[2], u[0] * t[1] - u[1] * t[0])


def _lower_half(full_t: torch.Tensor) -> torch.Tensor:
    """Keep the valid half [c, r ≥ c] of an (n, n, B) matrix, zero the rest."""
    n = full_t.shape[0]
    keep = torch.triu(torch.ones((n, n), dtype=torch.bool, device=full_t.device))[..., None]
    return torch.where(keep, full_t, torch.zeros_like(full_t))


def _sigma_columns(cov_t: torch.Tensor):
    """(L̃ (B, n, n) lower, dvec (B, n)) of the equilibrated factorization of
    a half-valid lanes covariance — what the kernels' shared core computes."""
    return equilibrated_cholesky(_mirror_half(cov_t).permute(2, 1, 0))


# ---------------------------------------------------------------------------
# the kernel and its plain version
# ---------------------------------------------------------------------------


def predict_lanes_plain(cov_t, mu_t, rr_t, coeff, offs, q0m, scal, aux_t=None):
    """The fused prediction in PyTorch, operand for operand what K2 computes:
    cov_t (53, 53, B) half-valid, mu_t (54, B), rr_t (3, B), coeff/offs the
    Markov coefficient −dt/τ and rest point, q0m the dt²-scaled Q with its
    orientation block zeroed, scal (14, 1). Shared mode (``aux_t`` None):
    coeff/offs (54, 1), q0m (53, 53, 1). Full mode: coeff/offs (54, B), q0m
    (53, 53, B) and aux_t (12, B), which replaces scal's anchor, orientation
    noise and current inflation. Returns (cov_out half-valid with zeros in
    the other half, mu_out)."""
    n, nb = TANGENT_DIM, cov_t.shape[-1]
    s = lambda i: scal[i, 0]
    if aux_t is None:
        lat0, mradinv, wv_scale = s(_S_LAT0), s(_S_MRADINV), s(_S_WVQ)
        qrot = lambda k: s(_S_QROT + k)
    else:
        lat0, mradinv, wv_scale = aux_t[_A_LAT0], aux_t[_A_MRADINV], aux_t[_A_WVQ]
        qrot = lambda k: aux_t[_A_QROT + k]
    dt = s(_S_DT)
    lt, dvec = _sigma_columns(cov_t)
    cols = (lt * dvec[:, :, None]).transpose(1, 2)  # (B, j, k): column j of L
    pm = torch.stack([cols, -cols], dim=2).reshape(nb, 2 * n, n)
    d = torch.cat([torch.zeros_like(pm[:, :1]), pm], dim=1).permute(1, 2, 0)  # (107, 53, B)
    mu = mu_t

    # boxplus + process model, (107, B) components
    x_pos = mu[None, 0:3] + d[:, 0:3]
    x_flat = mu[None, 7:54] + d[:, 6:53]  # (107, 47, B)
    ew, ex, ey, ez = _qexp(d[:, 3], d[:, 4], d[:, 5])
    qw, qx, qy, qz = _qnorm4(*_qmul(mu[3], mu[4], mu[5], mu[6], ew, ex, ey, ez))
    x_vel, x_acc = x_flat[:, 0:3], x_flat[:, 3:6]
    y_pos = x_pos + dt * x_vel
    lat = lat0 + x_pos[:, 0] * mradinv
    er_x = s(_S_EARTHW) * torch.cos(lat)
    er_z = s(_S_EARTHW) * torch.sin(lat)
    v = (rr_t[0] - x_flat[:, 6], rr_t[1] - x_flat[:, 7], rr_t[2] - x_flat[:, 8])
    wx, wy, wz = _rot_fwd((qw, qx, qy, qz), v)
    wx, wz = wx - er_x, wz - er_z
    gw, gx, gy, gz = _qexp(wx * dt, wy * dt, wz * dt)
    yqw, yqx, yqy, yqz = _qnorm4(*_qmul(qw, qx, qy, qz, gw, gx, gy, gz))
    y_flat = x_flat + coeff[None, 7:54] * (x_flat - offs[None, 7:54])
    y_vel = x_vel + dt * x_acc
    y_rest = y_flat[:, 3:]  # storage rows 10:54

    # mean: flats in closed form about the zero point (y0 + Σ(Yᵢ − y0)/107,
    # so the rounding scales with the spread, not the value), quaternion by
    # MEAN_ITERS Karcher steps
    inv_n = 1.0 / NSIG
    dev_pos, dev_vel, dev_rest = y_pos - y_pos[:1], y_vel - y_vel[:1], y_rest - y_rest[:1]
    dbar_pos, dbar_vel, dbar_rest = dev_pos.sum(0) * inv_n, dev_vel.sum(0) * inv_n, dev_rest.sum(0) * inv_n
    mean_pos, mean_vel, mean_rest = y_pos[0] + dbar_pos, y_vel[0] + dbar_vel, y_rest[0] + dbar_rest
    mw, mx, my, mz = yqw[0], yqx[0], yqy[0], yqz[0]
    for _ in range(MEAN_ITERS):
        rx, ry, rz = _qlog(*_qmul(mw, -mx, -my, -mz, yqw, yqx, yqy, yqz))
        gw, gx, gy, gz = _qexp(rx.sum(0) * inv_n, ry.sum(0) * inv_n, rz.sum(0) * inv_n)
        mw, mx, my, mz = _qnorm4(*_qmul(mw, mx, my, mz, gw, gx, gy, gz))
    mu_out = torch.cat([mean_pos, torch.stack([mw, mx, my, mz]), mean_vel, mean_rest], dim=0)

    # deviations (107, 53, B)
    rx, ry, rz = _qlog(*_qmul(mw, -mx, -my, -mz, yqw, yqx, yqy, yqz))
    D = torch.cat(
        [
            dev_pos - dbar_pos[None],
            torch.stack([rx, ry, rz], dim=1),
            dev_vel - dbar_vel[None],
            dev_rest - dbar_rest[None],
        ],
        dim=1,
    )

    # per-instance Q: R(μ_in)·Qrot·R(μ_in)ᵀ on the orientation block (lower
    # half computed and mirrored, so exactly symmetric) and the water-current
    # inflation on diagonal entries 46..49
    w0, x0, y0, z0 = mu[3], mu[4], mu[5], mu[6]
    R = (
        (1 - 2 * (y0 * y0 + z0 * z0), 2 * (x0 * y0 - w0 * z0), 2 * (x0 * z0 + w0 * y0)),
        (2 * (x0 * y0 + w0 * z0), 1 - 2 * (x0 * x0 + z0 * z0), 2 * (y0 * z0 - w0 * x0)),
        (2 * (x0 * z0 - w0 * y0), 2 * (y0 * z0 + w0 * x0), 1 - 2 * (x0 * x0 + y0 * y0)),
    )
    Qr = [[qrot(3 * i + j) for j in range(3)] for i in range(3)]
    T = [[R[i][0] * Qr[0][j] + R[i][1] * Qr[1][j] + R[i][2] * Qr[2][j] for j in range(3)] for i in range(3)]
    v0, v1, v2 = mu[7], mu[8], mu[9]
    wvq = wv_scale * (v0 * v0 + v1 * v1 + 100.0 * v2 * v2)

    # ½ΣDDᵀ (col c, row r) over all 107 points — the ± pairs are never folded
    acc = torch.einsum("icb,irb->crb", D, D)
    cov = 0.5 * acc + q0m
    add = torch.zeros_like(cov)
    for i in range(3):
        for j in range(i + 1):
            v = T[i][0] * R[j][0] + T[i][1] * R[j][1] + T[i][2] * R[j][2]
            add[3 + j, 3 + i] = v  # column j, row i ≥ j
    for k in range(46, 50):
        add[k, k] = wvq
    return _lower_half(cov + add).contiguous(), mu_out.contiguous()


def predict_lanes_cuda(cov_t, mu_t, rr_t, coeff, offs, q0m, scal, aux_t=None):
    """K2 on the card, same operands and outputs as
    :func:`predict_lanes_plain` (the other half of cov_out is left
    unwritten): kernel ``pose_predict`` in shared mode, ``pose_predict_full``
    when ``aux_t`` is given."""
    n, nb = TANGENT_DIM, cov_t.shape[-1]
    dev, dtype = cov_t.device, cov_t.dtype
    full = aux_t is not None
    lanes = nb if full else 1
    shapes = {
        "cov_t": (n, n, nb), "mu_t": (STORAGE_DIM, nb), "rr_t": (3, nb), "coeff": (STORAGE_DIM, lanes),
        "offs": (STORAGE_DIM, lanes), "q0m": (n, n, lanes), "scal": (_NSCAL, 1),
    }
    ops = dict(cov_t=cov_t, mu_t=mu_t, rr_t=rr_t, coeff=coeff, offs=offs, q0m=q0m, scal=scal)
    if full:
        shapes["aux_t"], ops["aux_t"] = (_NAUX, nb), aux_t
    for key, shape in shapes.items():
        if tuple(ops[key].shape) != shape:
            raise ValueError(f"pose_predict: {key} has shape {tuple(ops[key].shape)}, expected {shape}")
    cov_out = torch.empty((n, n, nb), dtype=dtype, device=dev)
    mu_out = torch.empty((STORAGE_DIM, nb), dtype=dtype, device=dev)
    cuda_lib.check_lanes("pose_predict", dev, dtype, cov_out=cov_out, mu_out=mu_out, **ops)
    ptrs = [t.data_ptr() for t in (cov_t, mu_t, rr_t, coeff, offs, q0m, scal)]
    if full:
        ptrs.append(aux_t.data_ptr())
    cuda_lib.KERNELS["pose_predict_full" if full else "pose_predict"].launch(
        dtype, *ptrs, cov_out.data_ptr(), mu_out.data_ptr(), nb, cuda_lib.stream_ptr(dev),
    )
    return cov_out, mu_out


_POSE_PREDICT = cuda_lib.kernel_op(
    "pose_predict",
    "(Tensor cov_t, Tensor mu_t, Tensor rr_t, Tensor coeff, Tensor offs, Tensor q0m, Tensor scal, Tensor? aux_t)"
    " -> (Tensor, Tensor)",
    lambda *a: predict_lanes_cuda(*a), lambda *a: predict_lanes_plain(*a),
    lambda cov_t, mu_t, *rest: (cov_t.new_empty(cov_t.shape), mu_t.new_empty(mu_t.shape)),
)


def _pose_predict_lanes(cov_t, mu_t, rr_t, coeff, offs, q0m, scal, aux_t=None):
    cuda_lib.route("predict_lanes", cov_t)
    return _POSE_PREDICT(cov_t, mu_t, rr_t, coeff, offs, q0m, scal, aux_t)


# ---------------------------------------------------------------------------
# packing and operands
# ---------------------------------------------------------------------------


def _pack_storage(mu) -> torch.Tensor:
    """PoseState bank → (B, 54) storage matrix (3×3 fields column-major)."""
    cm = lambda m: m.transpose(-1, -2).reshape(*m.shape[:-2], 9)
    return torch.cat(
        [
            mu.position, mu.orientation, mu.velocity, mu.acceleration, mu.bias_gyro,
            mu.bias_acc, mu.gravity, cm(mu.inertia), cm(mu.lin_damping), cm(mu.quad_damping),
            mu.water_velocity, mu.water_velocity_below, mu.bias_adcp, mu.water_density,
        ],
        dim=-1,
    )


def _unpack_storage(s: torch.Tensor, like):
    """(B, 54) storage matrix → PoseState shaped like ``like``."""
    icm = lambda v: v.reshape(*v.shape[:-1], 3, 3).transpose(-1, -2)
    return like._replace(
        position=s[..., 0:3], orientation=s[..., 3:7], velocity=s[..., 7:10],
        acceleration=s[..., 10:13], bias_gyro=s[..., 13:16], bias_acc=s[..., 16:19],
        gravity=s[..., 19:20], inertia=icm(s[..., 20:29]), lin_damping=icm(s[..., 29:38]),
        quad_damping=icm(s[..., 38:47]), water_velocity=s[..., 47:49],
        water_velocity_below=s[..., 49:51], bias_adcp=s[..., 51:53], water_density=s[..., 53:54],
    )


def _decay_vectors(params: "PoseUKFParams", dt, dtype):
    """Per-storage-row Markov coefficient −dt/τ and rest point: (54, 1) for a
    shared parameter set, (54, B) for a banked one."""
    dev = params.process_noise.device
    bs = tuple(params.gyro_bias_tau.shape)  # () shared, (B,) banked
    full = lambda k, v: v.to(dtype)[..., None].expand(*bs, k)
    zeros = lambda k: torch.zeros(*bs, k, dtype=dtype, device=dev)
    cm = lambda m: m.transpose(-1, -2).reshape(*bs, 9).to(dtype)
    taus = torch.cat(
        [
            zeros(13),  # pos, quat, vel, acc — no decay
            full(3, -dt / params.gyro_bias_tau),
            full(3, -dt / params.acc_bias_tau),
            zeros(1),  # gravity
            full(9, -dt / params.inertia_tau),
            full(9, -dt / params.lin_damping_tau),
            full(9, -dt / params.quad_damping_tau),
            full(4, -dt / params.water_velocity_tau),
            full(2, -dt / params.adcp_bias_tau),
            full(1, -dt / params.water_density_tau),
        ],
        dim=-1,
    )
    offs = torch.cat(
        [
            zeros(13),
            params.gyro_bias_offset.to(dtype),
            params.acc_bias_offset.to(dtype),
            zeros(1),
            cm(params.inertia_offset),
            cm(params.lin_damping_offset),
            cm(params.quad_damping_offset),
            zeros(6),
            params.water_density_offset.to(dtype)[..., None],
        ],
        dim=-1,
    )
    return taus.reshape(-1, STORAGE_DIM).T, offs.reshape(-1, STORAGE_DIM).T


@last_operands
def _predict_operands_shared(params: "PoseUKFParams", dt, dtype):
    """(coeff, offs, q0m, scal) kernel operands of the shared-parameter
    predict, on the parameters' device; kept for the next call with the same
    parameters and dt (:func:`~..utils.memo.last_operands`). A leaf it reads
    that carries a bank axis raises ValueError."""
    banked = ValueError(
        "the shared-mode predict takes one parameter set, and a leaf it reads carries a bank axis; "
        "a banked set takes the full mode: predict_lanes with every leaf banked "
        "(banked_predict_operands), followed by the update chain (update_model_lanes) in place of step_lanes"
    )
    dev = params.process_noise.device
    dt = torch.full((), float(dt), dtype=dtype, device=dev)
    try:  # a banked leaf does not line up with the shared ones
        coeff, offs = _decay_vectors(params, dt, dtype)
        q0 = params.process_noise.to(dtype)
        q0m = dt**2 * q0
        q0m[3:6, 3:6] = 0.0
        scal = torch.cat(
            [
                dt[None],
                params.projection.lat0.to(dtype)[None],
                (1.0 / params.projection.m_rad.to(dtype))[None],
                dt.new_full((1,), geo.EARTHW),
                (params.water_velocity_scale.to(dtype) * dt**3)[None],
                (dt**2 * q0[3:6, 3:6]).reshape(9),
            ]
        )[:, None]
    except RuntimeError as err:
        raise banked from err
    if coeff.shape != (STORAGE_DIM, 1) or offs.shape != (STORAGE_DIM, 1) or q0m.shape != (TANGENT_DIM,) * 2:
        raise banked
    # the lanes covariance is (col, row, B): q0m is symmetric, so its
    # transpose is itself
    return coeff, offs, q0m[:, :, None].contiguous(), scal


# ---------------------------------------------------------------------------
# lanes state and public entry points
# ---------------------------------------------------------------------------


class LanesBankState(NamedTuple):
    """PoseUKF bank in kernel layout. ``cov_t`` (53, 53, B) is valid only at
    [c, r ≥ c]; read it through :func:`from_lanes`."""

    cov_t: torch.Tensor  # (53, 53, B)
    mu_t: torch.Tensor  # (54, B)
    rr_t: torch.Tensor  # (3, B)


def to_lanes(state: "PoseUKFState") -> LanesBankState:
    """Bank-first state → kernel-layout state."""
    return LanesBankState(
        cov_t=state.cov.permute(2, 1, 0).contiguous(),
        mu_t=_pack_storage(state.mu).T.contiguous(),
        rr_t=state.rotation_rate.T.contiguous(),
    )


def from_lanes(lstate: LanesBankState, like: "PoseUKFState") -> "PoseUKFState":
    """Kernel-layout state → bank-first state shaped like ``like``, the
    half-valid covariance mirrored back to exact symmetry."""
    cov = _mirror_half(lstate.cov_t).permute(2, 1, 0).contiguous()
    mu = _unpack_storage(lstate.mu_t.T, like.mu)
    return like._replace(mu=mu, cov=cov, rotation_rate=lstate.rr_t.T)


def set_rotation_rate_lanes(lstate: LanesBankState, rr: torch.Tensor) -> LanesBankState:
    """Cache a new (B, 3) gyro input."""
    return lstate._replace(rr_t=rr.to(lstate.rr_t.dtype).T.contiguous())


class BankedPredictOperands(NamedTuple):
    """Kernel operands of the full (banked-parameter) prediction mode. They
    depend only on the parameter bank and the shared dt, so a mission builds
    them once with :func:`banked_predict_operands` and reuses them every
    tick (at a 131 072 bank ``q0m_t`` alone is 1.47 GB in float32)."""

    coeff: torch.Tensor  # (54, B) per-lane Markov coefficient −dt/τ
    offs: torch.Tensor  # (54, B) per-lane Markov rest point
    q0m_t: torch.Tensor  # (53, 53, B) per-lane dt²-scaled Q, orientation block zeroed
    aux_t: torch.Tensor  # (12, B) [lat0; 1/m_rad; dt²·Qrot ×9 row-major; wv_scale·dt³]
    scal: torch.Tensor  # (14, 1) only dt and EARTHW set


def _leaves(tree, path=""):
    if isinstance(tree, tuple):
        names = tree._fields if hasattr(tree, "_fields") else range(len(tree))
        for name, leaf in zip(names, tree):
            yield from _leaves(leaf, f"{path}.{name}")
    else:
        yield path, tree


def banked_predict_operands(params: "PoseUKFParams", dt, dtype) -> BankedPredictOperands:
    """Operands of the full prediction mode from a fully banked ``params``
    (a leading bank axis on every leaf). JAX's ``nb_padded`` argument has no
    counterpart: the port does not pad the bank."""
    nb = params.process_noise.shape[0]
    bad = [name for name, leaf in _leaves(params) if leaf.ndim == 0 or leaf.shape[0] != nb]
    if bad:
        raise ValueError(
            "the banked prediction needs a fully banked parameter set (a leading bank axis "
            f"on every leaf; broadcast shared leaves first); offending leaves: {bad[:6]}"
        )
    dev = params.process_noise.device
    dt = torch.full((), float(dt), dtype=dtype, device=dev)
    coeff, offs = _decay_vectors(params, dt, dtype)
    q0 = params.process_noise.to(dtype)  # (B, 53, 53)
    qrot = (dt**2 * q0[:, 3:6, 3:6]).reshape(nb, 9)
    q0m = dt**2 * q0
    q0m[:, 3:6, 3:6] = 0.0
    aux = torch.cat(
        [
            params.projection.lat0.to(dtype)[:, None],
            (1.0 / params.projection.m_rad.to(dtype))[:, None],
            qrot,
            (params.water_velocity_scale.to(dtype) * dt**3)[:, None],
        ],
        dim=-1,
    )
    scal = torch.zeros(_NSCAL, 1, dtype=dtype, device=dev)
    scal[_S_DT, 0] = dt
    scal[_S_EARTHW, 0] = geo.EARTHW
    return BankedPredictOperands(
        coeff=coeff.contiguous(), offs=offs.contiguous(), q0m_t=q0m.permute(1, 2, 0).contiguous(),
        aux_t=aux.T.contiguous(), scal=scal,
    )


def predict_lanes(
    lstate: LanesBankState, params: "PoseUKFParams", dt, banked_ops: BankedPredictOperands | None = None
) -> LanesBankState:
    """Fused prediction on kernel-layout state. A shared ``params`` takes the
    shared mode; a banked one the full mode, with its operands from
    ``banked_ops`` (built once per mission by :func:`banked_predict_operands`)
    or, if None, built for this call."""
    dtype = lstate.cov_t.dtype
    if banked_ops is None and params.process_noise.ndim == 3:
        banked_ops = banked_predict_operands(params, dt, dtype)
    if banked_ops is not None:
        ops = (banked_ops.coeff, banked_ops.offs, banked_ops.q0m_t, banked_ops.scal, banked_ops.aux_t)
    else:
        ops = _predict_operands_shared(params, dt, dtype)
    cov_t, mu_t = _pose_predict_lanes(lstate.cov_t, lstate.mu_t, lstate.rr_t, *ops)
    return lstate._replace(cov_t=cov_t, mu_t=mu_t)


def predict_fused_banked(state: "PoseUKFState", params: "PoseUKFParams", dt) -> "PoseUKFState":
    """Fused prediction over a bank-first state (shared or banked
    parameters): pack → one launch → unpack."""
    return from_lanes(predict_lanes(to_lanes(state), params, dt), state)

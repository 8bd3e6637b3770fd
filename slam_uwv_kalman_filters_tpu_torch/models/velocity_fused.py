"""The whole VelocityUKF step — kernel K6 and its plain version.

Counterpart of ``slam_uwv_kalman_filters_tpu/models/velocity_fused.py``. One
launch per bank computes a whole filter step: the 4×4 Cholesky, the 9 sigma
points and the orientation tracker through the full Fossen forward dynamics
(the reference's ``processMotionModel``, ``src/VelocityUKF.cpp:6-33``), the
unscented reconstruction, the tracker's advance (``motion_model->
sendEffort``, ``src/VelocityUKF.cpp:126-127``) and any chain of DVL and
pressure updates (``src/VelocityUKF.cpp:79-85, 106-112``). On a CUDA tensor
:func:`step_lanes` launches ``csrc/velocity_step.cu``; on a CPU tensor it
runs :func:`velocity_step_lanes_plain`.

Both measurements observe state rows directly (H selects rows), for which
the ukfom sigma-point update (a fresh ±chol(P) draw, S = ½ΣdZdZᵀ + R)
equals S = H·P·Hᵀ + R in exact arithmetic; both versions compute that form.
The mean of the 9 predicted points is taken about the zero sigma point,
Y₀ + Σ(Yᵢ − Y₀)/9, so its rounding scales with the spread; the gate is a
select (a threshold < 0 accepts any; a NaN S keeps the prior).

Lanes layout, bank last: ``cov_t`` (4, 4, B) in (col, row) order with both
halves valid, ``mu_t`` (4, B) [velocity xyz, z_position], ``eff_t`` (6, B)
and ``av_t`` (3, B) the cached inputs, ``trk_t`` (13, B) the tracker [pos 3,
quat wxyz 4, lin vel 3, ang vel 3]. The port does not pad the bank;
:func:`to_lanes` pads on request with the JAX package's convention
(identity covariance, copies of instance 0), and the lanes functions drop
pad lanes from their infos.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, TYPE_CHECKING

import torch

from ..ops import cuda_lib
from ..ops import ukf
from ..ops.linalg_small import _scalar_cholesky_factors, solve_spd
from ..utils.memo import last_operands
from .pose_fused import _qexp, _qmul, _qnorm4

if TYPE_CHECKING:
    from .velocity_ukf import VelocityUKFParams, VelocityUKFState

__all__ = [
    "FUSED_MODELS",
    "MAX_STEP_UPDATES",
    "StepUpdate",
    "VelLanesState",
    "to_lanes",
    "from_lanes",
    "set_inputs_lanes",
    "params_block",
    "predict_lanes",
    "update_model_lanes",
    "step_lanes",
    "velocity_step_lanes_cuda",
    "velocity_step_lanes_plain",
    "predict_fused_banked",
    "update_model_fused_banked",
]

DOF = 4  # velocity (3) + z_position (1), VelocityUKF.hpp:24-27
NSIG = 2 * DOF + 1  # 9
TRK_DIM = 13  # tracker PoseVelocityState: position 3, quat 4, lin vel 3, ang vel 3

# in-kernel measurement models: the state rows each observes; the position
# is the kernel's model id (csrc/velocity_step.cu)
FUSED_MODELS = {"dvl": (0, 1, 2), "pressure": (3,)}
MODEL_ID = {name: i for i, name in enumerate(FUSED_MODELS)}
# longest update chain of K6 (kVelMaxSteps, a compile-time cap)
MAX_STEP_UPDATES = 8

# indices of the (165, 1) parameter block
_S_DT = 0
_S_M = 1  # 1:37    inertia matrix, row-major
_S_MI = 37  # 37:73  its inverse
_S_DL = 73  # 73:109 linear damping
_S_DQ = 109  # 109:145 quadratic damping
_S_BW = 145  # buoyancy − weight
_S_RV = 146  # 146:149 restoring lever buoyancy·cob − weight·cog
_S_Q = 149  # 149:165 dt-scaled process noise, row-major 4×4
_NSCAL = 165


class VelLanesState(NamedTuple):
    """VelocityUKF bank in kernel layout."""

    cov_t: torch.Tensor  # (4, 4, B) covariance, (col, row, B)
    mu_t: torch.Tensor  # (4, B) velocity xyz, z_position
    eff_t: torch.Tensor  # (6, B) cached body-effort input
    av_t: torch.Tensor  # (3, B) cached gyro-rate input
    trk_t: torch.Tensor  # (13, B) orientation tracker


def _pack_tracker(ms) -> torch.Tensor:
    return torch.cat([ms.position, ms.orientation, ms.linear_velocity, ms.angular_velocity], dim=-1)


def to_lanes(state: "VelocityUKFState", lanes: int | None = None) -> VelLanesState:
    """Bank-first state → kernel layout; ``lanes`` > bank pads with the JAX
    package's pad lanes (identity covariance, copies of instance 0: finite
    arithmetic everywhere, a unit tracker quaternion)."""
    nb = state.cov.shape[0]
    pad = 0 if lanes is None else lanes - nb
    if pad < 0:
        raise ValueError(f"lanes={lanes} is narrower than the bank ({nb})")
    cov = state.cov
    mu = torch.cat([state.mu.velocity, state.mu.z_position], dim=-1)
    eff, av, trk = state.body_efforts, state.angular_velocity, _pack_tracker(state.model_state)
    if pad:
        cov = torch.cat([cov, torch.eye(DOF, dtype=cov.dtype, device=cov.device).expand(pad, DOF, DOF)])
        tile = lambda a: torch.cat([a, a[:1].expand(pad, a.shape[1])])
        mu, eff, av, trk = tile(mu), tile(eff), tile(av), tile(trk)
    return VelLanesState(
        cov_t=cov.permute(2, 1, 0).contiguous(), mu_t=mu.T.contiguous(), eff_t=eff.T.contiguous(),
        av_t=av.T.contiguous(), trk_t=trk.T.contiguous(),
    )


def from_lanes(lstate: VelLanesState, like: "VelocityUKFState") -> "VelocityUKFState":
    """Kernel layout → bank-first state shaped like ``like`` (pad lanes
    dropped)."""
    nb = like.cov.shape[0]
    mu = lstate.mu_t.T[:nb]
    trk = lstate.trk_t.T[:nb]
    return like._replace(
        mu=like.mu._replace(velocity=mu[:, 0:3], z_position=mu[:, 3:4]),
        cov=lstate.cov_t.permute(2, 1, 0)[:nb],
        body_efforts=lstate.eff_t.T[:nb],
        angular_velocity=lstate.av_t.T[:nb],
        model_state=like.model_state._replace(
            position=trk[:, 0:3], orientation=trk[:, 3:7], linear_velocity=trk[:, 7:10],
            angular_velocity=trk[:, 10:13],
        ),
    )


def set_inputs_lanes(lstate: VelLanesState, *, body_efforts=None, angular_velocity=None) -> VelLanesState:
    """Cache new (B, 6) efforts and/or (B, 3) gyro rates on kernel-layout
    state (``src/VelocityUKF.cpp:87-104``); a gyro input also refreshes the
    tracker's angular velocity, as ``velocity_ukf.integrate_gyro`` does.
    Pad lanes repeat instance 0."""
    nb_pad = lstate.mu_t.shape[-1]

    def lanes(a, like):
        a = torch.as_tensor(a, device=like.device).to(like.dtype)
        if a.shape[0] < nb_pad:
            a = torch.cat([a, a[:1].expand(nb_pad - a.shape[0], a.shape[1])])
        return a.T.contiguous()

    if body_efforts is not None:
        lstate = lstate._replace(eff_t=lanes(body_efforts, lstate.eff_t))
    if angular_velocity is not None:
        av_t = lanes(angular_velocity, lstate.av_t)
        lstate = lstate._replace(av_t=av_t, trk_t=torch.cat([lstate.trk_t[:10], av_t]))
    return lstate


@last_operands
def params_block(params: "VelocityUKFParams", dt, dtype) -> torch.Tensor:
    """(165, 1) parameter block of K6 on the parameters' device: dt, the
    inertia matrix and its inverse (precomputed here, by the unrolled SPD
    solve), linear and quadratic damping, the restoring-term scalars and the
    dt-scaled process noise (VelocityUKF scales Q linearly in dt,
    ``src/VelocityUKF.cpp:122``). It costs ~100 small launches, so the block
    is kept for the next call with the same parameters and dt
    (:func:`~..utils.memo.last_operands`)."""
    m = params.model
    dev = params.process_noise.device
    dt = torch.full((), float(dt), dtype=dtype, device=dev)
    inertia = m.inertia_matrix.to(dtype)
    minv = solve_spd(inertia, torch.eye(6, dtype=dtype, device=dev))
    w, b = m.weight.to(dtype), m.buoyancy.to(dtype)
    return torch.cat(
        [
            dt[None], inertia.reshape(36), minv.reshape(36), m.damping_linear.to(dtype).reshape(36),
            m.damping_quadratic.to(dtype).reshape(36), (b - w)[None], b * m.cob.to(dtype) - w * m.cog.to(dtype),
            (dt * params.process_noise.to(dtype)).reshape(16),
        ]
    )[:, None].contiguous()


# ---------------------------------------------------------------------------
# the plain version: each quantity a (B,) lane vector, as the kernel's thread
# ---------------------------------------------------------------------------


def _grid(G) -> torch.Tensor:
    """An n×n grid (lists) of (B,) lane vectors → a (B, n, n) tensor."""
    return torch.stack([torch.stack(row, -1) for row in G], -2)


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0]]


def _kalman_tail(P, S, C, nu_v, thr):
    """Linear-measurement tail: the m×m Crout factor of S, the NIS, the gain
    K = C·S⁻¹, the gate as a select, the correction K·ν and the exactly
    symmetric downdate P − (K·L_S)(K·L_S)ᵀ. Returns (corr, Pn, m2, acc),
    corr zero and Pn = P where the gate rejects."""
    n, m = len(P), len(nu_v)
    Sg = _grid(S)
    Ls = _scalar_cholesky_factors(Sg)
    # S⁻¹ν and the gain rows S⁻¹Cᵢ, one unrolled substitution per column
    sol = solve_spd(Sg, torch.stack([torch.stack(nu_v, -1)] + [torch.stack(C[i], -1) for i in range(n)], -1))
    q = [sol[:, a, 0] for a in range(m)]
    m2 = sum(nu_v[a] * q[a] for a in range(m))
    acc = (m2 <= thr) | (thr < 0.0)
    K = [[sol[:, a, 1 + i] for a in range(m)] for i in range(n)]
    corr = [torch.where(acc, sum(K[i][a] * nu_v[a] for a in range(m)), 0.0) for i in range(n)]
    W = [[sum(K[i][c] * Ls[c][a] for c in range(a, m)) for a in range(m)] for i in range(n)]
    Pn = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            Pn[i][j] = Pn[j][i] = torch.where(acc, P[i][j] - sum(W[i][a] * W[j][a] for a in range(m)), P[i][j])
    return corr, Pn, m2, acc


def velocity_step_lanes_plain(models, do_predict, cov_t, mu_t, eff_t, av_t, trk_t, scal, z_ts, r_ts, thrs):
    """The whole step in PyTorch, operand for operand what K6 computes:
    ``models`` names each update (:data:`FUSED_MODELS`), z_ts[k] (m, B),
    r_ts[k] (m, m, B), thrs[k] its threshold (< 0 accepts any); ``scal`` the
    (165, 1) block (read only with ``do_predict``). Returns (cov_out (4, 4,
    B), mu_out (4, B), trk_out (13, B), [(m2 (1, B), acc (1, B) as 1.0/0.0,
    nu_t (m, B)), …])."""
    mu = [mu_t[i] for i in range(DOF)]
    P = [[cov_t[min(i, j), max(i, j)] for j in range(DOF)] for i in range(DOF)]  # lower half
    trk_out = trk_t
    if do_predict:
        s = lambda i: scal[i, 0]
        dt = s(_S_DT)
        L = _scalar_cholesky_factors(_grid(P))
        zero = torch.zeros_like(mu[0])
        # (9, B) deltas per state row: point 0 zero, 2j+1 / 2j+2 the ±j-th column
        drow = [torch.stack([zero] + [v for j in range(DOF) for v in ((L[i][j], -L[i][j]) if j <= i else (zero, zero))])
                for i in range(DOF)]
        qw, qx, qy, qz = (trk_t[3 + i] for i in range(4))
        r2 = (2.0 * (qx * qz - qw * qy), 2.0 * (qy * qz + qw * qx), 1.0 - 2.0 * (qx * qx + qy * qy))
        rv = [s(_S_RV + i) for i in range(3)]
        g6 = [-(s(_S_BW) * r2[i]) for i in range(3)] + [-t for t in _cross(rv, r2)]
        tau = [eff_t[i] for i in range(6)]
        # the (10, B) dynamics rows: 9 sigma points, then the tracker
        nu = [torch.cat([mu[i] + drow[i], trk_t[7 + i][None]]) for i in range(3)]
        nu += [torch.cat([av_t[i].expand(NSIG, -1), trk_t[10 + i][None]]) for i in range(3)]
        p6 = [sum(s(_S_M + 6 * i + j) * nu[j] for j in range(6)) for i in range(6)]
        cor = _cross(nu[3:], p6[:3])
        cor += [c1 + c2 for c1, c2 in zip(_cross(nu[3:], p6[3:]), _cross(nu[:3], p6[:3]))]
        anu = [torch.abs(x) * x for x in nu]
        rhs = [tau[i] - cor[i] - sum(s(_S_DL + 6 * i + j) * nu[j] + s(_S_DQ + 6 * i + j) * anu[j] for j in range(6))
               - g6[i] for i in range(6)]
        new = [nu[i] + dt * sum(s(_S_MI + 6 * i + j) * rhs[j] for j in range(6)) for i in range(6)]
        # reconstruction over the sigma rows, about the zero point
        Y = [new[i][:NSIG] for i in range(3)]
        Y.append((mu[3] + drow[3]) + dt * (r2[0] * Y[0] + r2[1] * Y[1] + r2[2] * Y[2]))
        dY = []
        for i in range(DOF):
            y0 = Y[i][0]
            dbar = (Y[i][1:] - y0).sum(0) * (1.0 / NSIG)
            mu[i] = y0 + dbar
            dY.append((Y[i] - y0) - dbar)
        P = [[0.5 * (dY[i] * dY[j]).sum(0) + s(_S_Q + 4 * i + j) for j in range(DOF)] for i in range(DOF)]
        # the tracker's full kinematic step
        nlv = [new[i][NSIG] for i in range(3)]
        nav = [new[3 + i][NSIG] for i in range(3)]
        u = [qx, qy, qz]
        t2 = [2.0 * c for c in _cross(u, nlv)]
        rot = [nlv[i] + qw * t2[i] + _cross(u, t2)[i] for i in range(3)]
        npos = [trk_t[i] + dt * rot[i] for i in range(3)]
        qn = _qnorm4(*_qmul(qw, qx, qy, qz, *_qexp(nav[0] * dt, nav[1] * dt, nav[2] * dt)))
        trk_out = torch.stack(npos + list(qn) + nlv + nav)
    infos = []
    for model, z_t, r_t, thr in zip(models, z_ts, r_ts, thrs):
        rows = FUSED_MODELS[model]
        m = len(rows)
        S = [[P[rows[a]][rows[c]] + r_t[a, c] for c in range(m)] for a in range(m)]
        nu_v = [z_t[a] - mu[rows[a]] for a in range(m)]
        C = [[P[i][rows[a]] for a in range(m)] for i in range(DOF)]
        corr, P, m2, acc = _kalman_tail(P, S, C, nu_v, thr)
        mu = [mu[i] + corr[i] for i in range(DOF)]
        infos.append((m2[None], acc.to(cov_t.dtype)[None], torch.stack(nu_v)))
    cov_out = torch.stack([torch.stack([P[i][j] for i in range(DOF)]) for j in range(DOF)])
    return cov_out.contiguous(), torch.stack(mu).contiguous(), trk_out.contiguous(), infos


def velocity_step_lanes_cuda(models, do_predict, cov_t, mu_t, eff_t, av_t, trk_t, scal, z_ts, r_ts, thrs):
    """K6 on the card, same operands and outputs as
    :func:`velocity_step_lanes_plain`."""
    if len(models) > MAX_STEP_UPDATES:
        raise ValueError(f"the VelocityUKF step kernel chains at most {MAX_STEP_UPDATES} updates "
                         f"(MAX_STEP_UPDATES, its compile-time cap); got {len(models)}")
    nb = cov_t.shape[-1]
    dev, dtype = cov_t.device, cov_t.dtype
    ops = dict(cov_t=cov_t, mu_t=mu_t, eff_t=eff_t, av_t=av_t, trk_t=trk_t)
    shapes = dict(cov_t=(DOF, DOF, nb), mu_t=(DOF, nb), eff_t=(6, nb), av_t=(3, nb), trk_t=(TRK_DIM, nb))
    if do_predict:
        ops["scal"], shapes["scal"] = scal, (_NSCAL, 1)
    for k, model in enumerate(models):
        m = len(FUSED_MODELS[model])
        ops[f"z_t{k}"], shapes[f"z_t{k}"] = z_ts[k], (m, nb)
        ops[f"r_t{k}"], shapes[f"r_t{k}"] = r_ts[k], (m, m, nb)
    for key, shape in shapes.items():
        if tuple(ops[key].shape) != shape:
            raise ValueError(f"velocity_step: {key} has shape {tuple(ops[key].shape)}, expected {shape}")
    empty = lambda *s: torch.empty(s, dtype=dtype, device=dev)
    cov_out, mu_out, trk_out = empty(DOF, DOF, nb), empty(DOF, nb), empty(TRK_DIM, nb)
    infos = [(empty(1, nb), empty(1, nb), empty(len(FUSED_MODELS[model]), nb)) for model in models]
    cuda_lib.check_lanes("velocity_step", dev, dtype, cov_out=cov_out, **ops)
    ptrs = lambda ts: cuda_lib.host_array(ctypes.c_void_p, [t.data_ptr() for t in ts])
    chain = (
        cuda_lib.host_array(ctypes.c_int, [MODEL_ID[model] for model in models]),
        ptrs(z_ts), ptrs(r_ts), cuda_lib.host_array(ctypes.c_double, [float(t) for t in thrs]),
        ptrs([i[0] for i in infos]), ptrs([i[1] for i in infos]), ptrs([i[2] for i in infos]),
    )
    models_a, z_a, r_a, thr_a, m2_a, acc_a, nu_a = (ctypes.addressof(a) for a in chain)
    cuda_lib.KERNELS["velocity_step"].launch(
        dtype, int(do_predict), *(t.data_ptr() for t in (cov_t, mu_t, eff_t, av_t, trk_t)),
        scal.data_ptr() if do_predict else None, len(models), models_a, z_a, r_a, thr_a, m2_a, acc_a, nu_a,
        cov_out.data_ptr(), mu_out.data_ptr(), trk_out.data_ptr(), nb, cuda_lib.stream_ptr(dev),
    )
    return cov_out, mu_out, trk_out, infos


def _velocity_step_lanes(models, do_predict, cov_t, mu_t, eff_t, av_t, trk_t, scal, z_ts, r_ts, thrs):
    if cov_t.device.type == "cuda":
        return velocity_step_lanes_cuda(models, do_predict, cov_t, mu_t, eff_t, av_t, trk_t, scal, z_ts, r_ts, thrs)
    if cov_t.device.type == "cpu":
        return velocity_step_lanes_plain(models, do_predict, cov_t, mu_t, eff_t, av_t, trk_t, scal, z_ts, r_ts, thrs)
    raise ValueError(f"velocity step_lanes: no path for device {cov_t.device}")


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


class StepUpdate(NamedTuple):
    """One measurement of a VelocityUKF step chain (:func:`step_lanes`);
    ``model`` is ``"dvl"`` or ``"pressure"``."""

    model: str
    z: torch.Tensor  # (B, m)
    meas_cov: torch.Tensor  # (B, m, m) or (m, m)
    gate_threshold: float | None = None


def _run(lstate: VelLanesState, params, dt, updates, do_predict: bool, nb: int):
    dtype, dev = lstate.cov_t.dtype, lstate.cov_t.device
    nb_pad = lstate.cov_t.shape[-1]
    updates = [u if isinstance(u, StepUpdate) else StepUpdate(*u) for u in updates]
    if len(updates) > MAX_STEP_UPDATES:
        raise ValueError(f"the VelocityUKF step chains at most {MAX_STEP_UPDATES} updates "
                         f"(MAX_STEP_UPDATES, the kernel's compile-time cap); got {len(updates)}")
    z_ts, r_ts, thrs = [], [], []
    for u in updates:
        if u.model not in FUSED_MODELS:
            raise ValueError(f"no in-kernel VelocityUKF measurement {u.model!r}; models: {tuple(FUSED_MODELS)}")
        m = len(FUSED_MODELS[u.model])
        z = torch.as_tensor(u.z, device=dev).to(dtype)
        if z.shape[0] != nb:
            raise ValueError(f"inconsistent bank sizes across step updates: {z.shape[0]} vs {nb}")
        if z.shape != (nb, m) or nb > nb_pad:
            raise ValueError(f"{u.model}: z must be (bank={nb} <= {nb_pad} lanes, {m}); got {tuple(z.shape)}")
        r = torch.as_tensor(u.meas_cov, device=dev).to(dtype).expand(nb, m, m)
        pad = nb_pad - nb
        if pad:  # neutral pad-lane measurement: z = 0, R = I
            z = torch.cat([z, torch.zeros((pad, m), dtype=dtype, device=dev)])
            r = torch.cat([r, torch.eye(m, dtype=dtype, device=dev).expand(pad, m, m)])
        z_ts.append(z.T.contiguous())
        r_ts.append(r.permute(1, 2, 0).contiguous())
        thrs.append(-1.0 if u.gate_threshold is None else float(u.gate_threshold))
    scal = params_block(params, dt, dtype) if do_predict else None
    cov_t, mu_t, trk_t, outs = _velocity_step_lanes(
        tuple(u.model for u in updates), do_predict, lstate.cov_t, lstate.mu_t, lstate.eff_t, lstate.av_t,
        lstate.trk_t, scal, z_ts, r_ts, thrs,
    )
    infos = [
        ukf.UpdateInfo(mahalanobis2=m2[0, :nb], accepted=acc[0, :nb] > 0.5, innovation=nu_t.T[:nb])
        for m2, acc, nu_t in outs
    ]
    return lstate._replace(cov_t=cov_t, mu_t=mu_t, trk_t=trk_t), infos


def step_lanes(lstate: VelLanesState, params: "VelocityUKFParams", dt, updates: Sequence[StepUpdate] = (),
               *, nb: int | None = None):
    """One whole VelocityUKF step — predict(dt) and a chain of measurement
    updates — in one launch on kernel-layout state, with one shared
    parameter set. ``nb`` is the true bank (default: the first update's
    ``z.shape[0]``, else every lane). Returns ``(VelLanesState,
    [UpdateInfo, …])``."""
    updates = [u if isinstance(u, StepUpdate) else StepUpdate(*u) for u in updates]
    if nb is None:
        nb = updates[0].z.shape[0] if updates else lstate.cov_t.shape[-1]
    return _run(lstate, params, dt, updates, True, nb)


def predict_lanes(lstate: VelLanesState, params: "VelocityUKFParams", dt, *,
                  nb: int | None = None) -> VelLanesState:
    """The prediction alone (``VelocityUKF::predictionStepImpl``,
    ``src/VelocityUKF.cpp:114-130``) on kernel-layout state."""
    return _run(lstate, params, dt, [], True, lstate.cov_t.shape[-1] if nb is None else nb)[0]


def update_model_lanes(model: str, lstate: VelLanesState, z, meas_cov, gate_threshold=None):
    """One measurement update (no predict) on kernel-layout state. Returns
    ``(VelLanesState, UpdateInfo)``."""
    z = torch.as_tensor(z)
    out, infos = _run(lstate, None, None, [StepUpdate(model, z, meas_cov, gate_threshold)], False, z.shape[0])
    return out, infos[0]


def predict_fused_banked(bstate: "VelocityUKFState", params: "VelocityUKFParams", dt) -> "VelocityUKFState":
    """Bank-first prediction: pack → one launch → unpack."""
    return from_lanes(predict_lanes(to_lanes(bstate), params, dt), bstate)


def update_model_fused_banked(model: str, bstate: "VelocityUKFState", z, meas_cov, gate_threshold=None):
    """Bank-first update of ``model``: pack → one launch → unpack."""
    ls, info = update_model_lanes(model, to_lanes(bstate), z, meas_cov, gate_threshold)
    return from_lanes(ls, bstate), info

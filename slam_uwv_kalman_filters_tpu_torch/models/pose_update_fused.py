"""Fused PoseUKF measurement updates — kernels K3 and K4 and their plain
versions.

Counterpart of ``slam_uwv_kalman_filters_tpu/models/pose_update_fused.py``.
Two routes, as in JAX:

* **In-kernel models (K3)** — ``_make_update_model_kernel`` with
  ``_factor_innovation``, ``_update_tail_from_sc`` and ``_model_measurement``:
  the whole update in one launch, for the seven measurement models of
  :data:`FUSED_MODELS` (below).
* **The whole step (K5)** — ``_make_step_kernel`` / ``_pose_step_lanes``:
  K2's shared-mode predict and then a chain of K3's updates in one launch
  (:func:`step_lanes`, :func:`step_velocity_lanes`); each update draws its
  sigma points afresh from the covariance as it then stands, so the chain
  equals ``predict_lanes`` followed by ``update_model_lanes`` calls. At most
  :data:`MAX_STEP_UPDATES` updates of the six models of :data:`STEP_MODELS`.
* **Generic h (K4)** — ``_make_update_kernel`` / ``_update_tail``: K1's sigma
  deltas of the lanes covariance, the measurement model ``h`` evaluated in
  PyTorch on the rows it depends on (:func:`_measurement_stage`), then the
  update tail in one launch: S = ½ΣdZdZᵀ + R, C = ½ΣδdZᵀ over all 107
  points, and the gain, gate, correction and downdate of K3 (one shared copy,
  ``csrc/warp_update.cuh``'s ``warp_gain_and_mean`` and ``block_downdate``).
  :func:`update_lanes` and :func:`update_fused_banked` take it; so does a
  banked vehicle model in :func:`update_body_efforts_lanes`. The measurement
  dimension is capped at :data:`MAX_TAIL_M`.

The in-kernel route:

1. The shared equilibrated Cholesky keeps the finalized factor columns L̃
   and the row scale d (L = diag(d)·L̃).
2. h is evaluated on the sigma points μ ⊞ (±column j) and μ; the (107, 53)
   delta tensor is never built: delta row k of column j is ±L̃[k, j]·d[k].
3. S = ½Σ dz dzᵀ + R over {0, +cols, −cols} (two passes: mean, then
   deviations), C = ½·d ⊙ Σⱼ L̃[:, j]·(Z⁺ⱼ − Z⁻ⱼ) straight from the factor.
4. The m×m Cholesky of S, W = C·L_S⁻ᵀ by ascending forward substitution,
   y = L_S⁻¹ν, the Mahalanobis² |y|², the gate (a select: a threshold < 0
   accepts any; a NaN S leaves the instance bit-identical to its prior), the
   manifold correction μ ⊞ W·y and the half-triangle downdate cov − W·Wᵀ.

On a CUDA tensor :func:`update_model_lanes` launches ``csrc/pose_update.cu``
and :func:`update_lanes` ``csrc/pose_update_tail.cu``, :func:`step_lanes`
``csrc/pose_step.cu``; on a CPU tensor they run :func:`update_model_lanes_plain`,
:func:`update_tail_plain` and :func:`pose_step_lanes_plain`. Model parameters
come as 5 aux values, shared (a (6, 1) ``scal`` block: threshold + 5 aux)
or per instance (a (5, B) ``aux_t``); ``body_efforts`` also reads the
119-scalar shared vehicle-model block of :func:`_efforts_model_scal`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, TYPE_CHECKING

import torch

from ..ops import cuda_lib
from ..ops import geodesy as geo
from ..ops import manifolds as mf
from ..ops import ukf
from ..ops.kernels import sigma_deltas_lanes
from .pose_fused import (
    NSIG,
    STORAGE_DIM,
    TANGENT_DIM,
    _cross,
    _lower_half,
    _mirror_half,
    _qexp,
    _qmul,
    _qnorm4,
    _rot_fwd,
    _rot_inv,
    _sigma_columns,
    _predict_operands_shared,
    _unpack_storage,
    from_lanes,
    predict_lanes_plain,
    to_lanes,
)

if TYPE_CHECKING:
    from .pose_ukf import PoseUKFParams, PoseUKFState

__all__ = [
    "FUSED_MODELS",
    "MAX_STEP_UPDATES",
    "MODEL_NAMES",
    "MAX_TAIL_M",
    "STEP_MODELS",
    "StepUpdate",
    "pose_step_lanes_cuda",
    "pose_step_lanes_plain",
    "step_lanes",
    "step_velocity_lanes",
    "update_fused_banked",
    "update_lanes",
    "update_tail_cuda",
    "update_tail_plain",
    "update_model_lanes",
    "update_model_lanes_cuda",
    "update_model_lanes_plain",
    "update_model_fused_banked",
    "update_velocity_lanes",
    "update_velocity_fused_banked",
    "update_body_efforts_lanes",
]

# name → measurement dimension; the position in this table is the kernel's
# model id (csrc/pose_update.cu)
FUSED_MODELS = {
    "velocity": 3,  # h = R(q)⁻¹·v
    "z_position": 1,  # h = position.z
    "xy_position": 2,  # h = position.xy
    "acceleration": 3,  # h = R⁻¹(a + [0,0,g]) + b_acc
    "pressure": 1,  # h = p_atm − z_sensor·g·ρ
    "water_velocity": 2,  # ADCP cell-weighted blend
    "body_efforts": 6,  # Fossen inverse dynamics
}
MODEL_ID = {name: i for i, name in enumerate(FUSED_MODELS)}
_EFF_NSCAL = 119
# largest measurement dimension of the generic-h tail K4 (instantiated for
# m = 1 … 6 at compile time, csrc/pose_update_tail.cu; the JAX package passes
# 1, 2, 3 and 6)
MAX_TAIL_M = 6
# the whole step K5 (csrc/pose_step.cu): the models it chains (those that
# read no parameter block) and its compile-time cap on the chain's length
STEP_MODELS = tuple(m for m in FUSED_MODELS if m != "body_efforts")
MAX_STEP_UPDATES = 8


def _efforts_model_scal(params: "PoseUKFParams", dtype) -> torch.Tensor:
    """(119, 1) shared vehicle-model block: [M row-major ×36; D_lin ×36;
    D_quad ×36; weight; buoyancy; cog ×3; cob ×3; imu_in_body ×3]."""
    m = params.model
    if m.inertia_matrix.ndim != 2 or params.imu_in_body.ndim != 1:
        raise ValueError(
            "the in-kernel body_efforts model takes a shared vehicle model; a banked one "
            "goes through update_lanes (update_body_efforts_lanes routes it)"
        )
    return torch.cat(
        [
            m.inertia_matrix.reshape(-1), m.damping_linear.reshape(-1),
            m.damping_quadratic.reshape(-1), m.weight.reshape(1), m.buoyancy.reshape(1),
            m.cog.reshape(-1), m.cob.reshape(-1), params.imu_in_body.reshape(-1),
        ]
    ).to(dtype)[:, None].contiguous()


# ---------------------------------------------------------------------------
# in-kernel measurement models, plain form: mu (54, B) storage rows, d a
# delta accessor d(k) → (K, B) tangent row k of the sigma points
# ---------------------------------------------------------------------------


def _model_measurement(model, mu, d, aux, mscal=None):
    """Measurement components (tuple of m (K, B) tensors) of ``model`` on the
    sigma points μ ⊞ δ; fields the model does not read stay at the mean."""
    x = lambda s, k: mu[s] + d(k)  # storage row s, tangent row k

    def quat():
        ew, ex, ey, ez = _qexp(d(3), d(4), d(5))
        return _qnorm4(*_qmul(mu[3], mu[4], mu[5], mu[6], ew, ex, ey, ez))

    if model == "velocity":
        return _rot_inv(quat(), (x(7, 6), x(8, 7), x(9, 8)))
    if model == "z_position":
        return (x(2, 2),)
    if model == "xy_position":
        return (x(0, 0), x(1, 1))
    if model == "acceleration":
        g = x(19, 18)
        rx, ry, rz = _rot_inv(quat(), (x(10, 9), x(11, 10), x(12, 11) + g))
        return (rx + x(16, 15), ry + x(17, 16), rz + x(18, 17))
    if model == "pressure":
        p_atm, lx, ly, lz = aux[0], aux[1], aux[2], aux[3]
        _, _, rlz = _rot_fwd(quat(), (lx, ly, lz))
        sensor_z = x(2, 2) + rlz
        return (p_atm - sensor_z * x(19, 18) * x(53, 52),)
    if model == "water_velocity":
        cw = aux[0]
        q = quat()
        v = (x(7, 6), x(8, 7), x(9, 8))
        wv = (x(47, 46), x(48, 47))
        wvb = (x(49, 48), x(50, 49))
        ax, ay, _ = _rot_inv(q, (v[0] - wv[0], v[1] - wv[1], v[2]))
        bx, by, _ = _rot_inv(q, (v[0] - wvb[0], v[1] - wvb[1], v[2]))
        return (
            cw * bx + (1.0 - cw) * ax + x(51, 50),
            cw * by + (1.0 - cw) * ay + x(52, 51),
        )
    if model == "body_efforts":
        if mscal is None:
            raise ValueError("body_efforts needs the shared model-parameter block")
        w = (aux[0], aux[1], aux[2])  # each instance's compensated body rate
        weight, buoy = mscal[108], mscal[109]
        cog = (mscal[110], mscal[111], mscal[112])
        cob = (mscal[113], mscal[114], mscal[115])
        pib = (mscal[116], mscal[117], mscal[118])

        def embedded(base, sb, tb):
            # shared 6×6 with the (0,1,5)×(0,1,5) block from the sigma point's
            # col-major mat33 (storage index k = 3·b2 + a2)
            grid = [[mscal[base + 6 * i + j] for j in range(6)] for i in range(6)]
            for a2, i in enumerate((0, 1, 5)):
                for b2, j in enumerate((0, 1, 5)):
                    k = 3 * b2 + a2
                    grid[i][j] = x(sb + k, tb + k)
            return grid

        M6, L6, Q6 = embedded(0, 20, 19), embedded(36, 29, 28), embedded(72, 38, 37)
        q = quat()
        vbx, vby, vbz = _rot_inv(q, (x(7, 6), x(8, 7), x(9, 8)))
        cw = _cross(w, pib)
        wvx, wvy, wvz = _rot_inv(q, (x(47, 46), x(48, 47), 0.0))
        v6 = (vbx - cw[0] - wvx, vby - cw[1] - wvy, vbz - cw[2] - wvz, w[0], w[1], w[2])
        abx, aby, abz = _rot_inv(q, (x(10, 9), x(11, 10), x(12, 11)))
        cc = _cross(w, cw)
        a3 = (abx - cc[0], aby - cc[1], abz - cc[2])
        Ma = [M6[i][0] * a3[0] + M6[i][1] * a3[1] + M6[i][2] * a3[2] for i in range(6)]
        p1 = [sum(M6[i][j] * v6[j] for j in range(6)) for i in range(3)]
        p2 = [sum(M6[3 + i][j] * v6[j] for j in range(6)) for i in range(3)]
        c1, c2a, c2b = _cross(w, p1), _cross(w, p2), _cross(v6[:3], p1)
        cor = (c1[0], c1[1], c1[2], c2a[0] + c2b[0], c2a[1] + c2b[1], c2a[2] + c2b[2])
        av6 = [torch.abs(v) * v for v in v6]
        D = [
            sum(L6[i][j] * v6[j] for j in range(6)) + sum(Q6[i][j] * av6[j] for j in range(6))
            for i in range(6)
        ]
        upx, upy, upz = _rot_inv(q, (0.0, 0.0, 1.0))
        dwb = buoy - weight
        fg = (-upx * weight, -upy * weight, -upz * weight)
        fb = (upx * buoy, upy * buoy, upz * buoy)
        tg, tb2 = _cross(cog, fg), _cross(cob, fb)
        g6 = (
            -(upx * dwb), -(upy * dwb), -(upz * dwb),
            -(tg[0] + tb2[0]), -(tg[1] + tb2[1]), -(tg[2] + tb2[2]),
        )
        return tuple(Ma[i] + cor[i] + D[i] + g6[i] for i in range(6))
    raise ValueError(f"no in-kernel measurement model {model!r}")


# ---------------------------------------------------------------------------
# the kernel and its plain version
# ---------------------------------------------------------------------------


def update_model_lanes_plain(model, z_t, r_t, mu_t, cov_t, scal, aux_t=None, mscal=None):
    """The in-kernel-model update in PyTorch, operand for operand what K3
    computes: z_t (m, B), r_t (m, m, B), mu_t (54, B), cov_t (53, 53, B)
    half-valid, scal (6, 1) [threshold; aux ×5], aux_t (5, B) per-instance
    aux or None, mscal (119, 1) for body_efforts. Returns (cov_out half-valid
    with zeros in the other half, mu_out, m2 (1, B), acc (1, B) as 1.0/0.0,
    nu_t (m, B))."""
    m = FUSED_MODELS[model]
    nb = cov_t.shape[-1]
    lt, dvec = _sigma_columns(cov_t)  # (B, k, j), (B, k)
    cols = (lt.permute(2, 1, 0) * dvec.T[None])  # (j, k, B): column j of L at row k
    aux = tuple(aux_t[i] for i in range(5)) if aux_t is not None else tuple(scal[1 + i, 0] for i in range(5))
    msc = None if mscal is None else [mscal[k, 0] for k in range(_EFF_NSCAL)]
    Zp = _model_measurement(model, mu_t, lambda k: cols[:, k], aux, msc)
    Zm = _model_measurement(model, mu_t, lambda k: -cols[:, k], aux, msc)
    zero = torch.zeros((1, nb), dtype=cov_t.dtype, device=cov_t.device)
    Z0 = _model_measurement(model, mu_t, lambda k: zero, aux, msc)

    # mean and deviations about the zero point, z0 + Σ(Zᵢ − z0)/107: the
    # rounding then scales with the spread, not with the value (~1e5 Pa)
    inv_n = 1.0 / NSIG
    ep = [Zp[a] - Z0[a] for a in range(m)]
    em = [Zm[a] - Z0[a] for a in range(m)]
    dzbar = [(ep[a].sum(0) + em[a].sum(0)) * inv_n for a in range(m)]
    nu = torch.stack([(z_t[a] - Z0[a][0]) - dzbar[a] for a in range(m)])
    dzp = [ep[a] - dzbar[a] for a in range(m)]
    dzm = [em[a] - dzbar[a] for a in range(m)]
    dz0 = [-dzbar[a] for a in range(m)]
    S = [[None] * m for _ in range(m)]
    for a in range(m):
        for b2 in range(a + 1):
            S[a][b2] = S[b2][a] = 0.5 * (
                (dzp[a] * dzp[b2]).sum(0) + (dzm[a] * dzm[b2]).sum(0) + dz0[a] * dz0[b2]
            ) + r_t[a, b2]
    lt_kj = lt.permute(1, 2, 0)  # (k, j, B)
    C = [0.5 * dvec.T * (lt_kj * (Zp[a] - Zm[a])[None]).sum(1) for a in range(m)]  # (53, B)
    cov_out, mu_out, m2, acc = _update_tail_plain(S, C, nu, mu_t, cov_t, scal[0, 0])
    return cov_out, mu_out, m2, acc, nu.contiguous()


def _update_tail_plain(S, C, nu, mu_t, cov_t, thr):
    """Gain, gate, correction and downdate shared by the plain K3 and K4,
    from S (m×m of (B,)), C (m of (53, B)) and ν (m, B): the m×m Cholesky of
    S, W = C·L⁻ᵀ (ascending), y = L⁻¹ν, m2 = |y|², the gate as a select (a
    threshold < 0 accepts any; a NaN S leaves the prior), μ ⊞ W·y and the
    half-triangle downdate cov − W·Wᵀ. Returns (cov_out half-valid with
    zeros in the other half, mu_out, m2 (1, B), acc (1, B) as 1.0/0.0)."""
    m = len(C)
    L = [[None] * m for _ in range(m)]
    for j in range(m):
        s = S[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(s)
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, m):
            t = S[i][j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t * inv_d
    inv_diag = [1.0 / L[i][i] for i in range(m)]
    W, y = [None] * m, [None] * m
    for i in range(m):
        t, u = C[i], nu[i]
        for k in range(i):
            t = t - L[i][k] * W[k]
            u = u - L[i][k] * y[k]
        W[i], y[i] = t * inv_diag[i], u * inv_diag[i]
    m2 = sum(y[i] * y[i] for i in range(m))
    thr = torch.as_tensor(thr, dtype=cov_t.dtype, device=cov_t.device)
    acc = (m2 <= thr) | (thr < 0.0)

    corr = sum(W[i] * y[i] for i in range(m))  # (53, B)
    mu = mu_t
    ew, ex, ey, ez = _qexp(corr[3], corr[4], corr[5])
    q = torch.stack(_qnorm4(*_qmul(mu[3], mu[4], mu[5], mu[6], ew, ex, ey, ez)))
    mu_new = torch.cat([mu[0:3] + corr[0:3], q, mu[7:54] + corr[6:53]])
    mu_out = torch.where(acc[None], mu_new, mu)

    Wt = torch.stack(W)  # (m, 53, B)
    down = torch.einsum("icb,irb->crb", Wt, Wt)
    prior = _mirror_half(cov_t)
    cov_out = _lower_half(torch.where(acc[None, None], prior - down, prior))
    return (cov_out.contiguous(), mu_out.contiguous(), m2[None].contiguous(),
            acc.to(cov_t.dtype)[None].contiguous())


def update_tail_plain(deltas_t, dz_t, nu_t, r_t, mu_t, cov_t, thr):
    """The generic-h update tail in PyTorch, operand for operand what K4
    computes: deltas_t (107, 53, B) sigma deltas, dz_t (107, m, B)
    measurement deviations, nu_t (m, B) innovation, r_t (m, m, B), mu_t
    (54, B), cov_t (53, 53, B) half-valid, ``thr`` the gate threshold (< 0
    accepts any). S = ½ΣdZdZᵀ + R and C = ½ΣδdZᵀ over all 107 points, then
    :func:`_update_tail_plain`. Returns (cov_out, mu_out, m2 (1, B), acc
    (1, B))."""
    m = dz_t.shape[1]
    S = [[None] * m for _ in range(m)]
    for a in range(m):
        for b2 in range(a + 1):
            S[a][b2] = S[b2][a] = 0.5 * (dz_t[:, a] * dz_t[:, b2]).sum(0) + r_t[a, b2]
    C = 0.5 * torch.einsum("pkb,pib->ikb", deltas_t, dz_t)  # (m, 53, B)
    return _update_tail_plain(S, list(C), nu_t, mu_t, cov_t, thr)


def update_tail_cuda(deltas_t, dz_t, nu_t, r_t, mu_t, cov_t, thr):
    """K4 on the card, same operands and outputs as :func:`update_tail_plain`
    (the other half of cov_out is left unwritten): one warp per instance, no
    scratch."""
    n, nb, m = TANGENT_DIM, cov_t.shape[-1], dz_t.shape[1]
    dev, dtype = cov_t.device, cov_t.dtype
    ops = dict(deltas_t=deltas_t, dz_t=dz_t, nu_t=nu_t, r_t=r_t, mu_t=mu_t, cov_t=cov_t)
    shapes = dict(deltas_t=(NSIG, n, nb), dz_t=(NSIG, m, nb), nu_t=(m, nb), r_t=(m, m, nb),
                  mu_t=(STORAGE_DIM, nb), cov_t=(n, n, nb))
    for key, shape in shapes.items():
        if tuple(ops[key].shape) != shape:
            raise ValueError(f"pose_update_tail: {key} has shape {tuple(ops[key].shape)}, expected {shape}")
    empty = lambda *s: torch.empty(s, dtype=dtype, device=dev)
    cov_out, mu_out, m2, acc = empty(n, n, nb), empty(STORAGE_DIM, nb), empty(1, nb), empty(1, nb)
    cuda_lib.check_lanes("pose_update_tail", dev, dtype, cov_out=cov_out, **ops)
    cuda_lib.KERNELS["pose_update_tail"].launch(
        dtype, m, *(t.data_ptr() for t in (deltas_t, dz_t, nu_t, r_t, mu_t, cov_t)), float(thr),
        cov_out.data_ptr(), mu_out.data_ptr(), m2.data_ptr(), acc.data_ptr(), nb, cuda_lib.stream_ptr(dev),
    )
    return cov_out, mu_out, m2, acc


_lanes_outputs = lambda cov_t, mu_t, *rows: (
    cov_t.new_empty(cov_t.shape), mu_t.new_empty(mu_t.shape), *(cov_t.new_empty(r, cov_t.shape[-1]) for r in rows))
_POSE_UPDATE_TAIL = cuda_lib.kernel_op(
    "pose_update_tail",
    "(Tensor deltas_t, Tensor dz_t, Tensor nu_t, Tensor r_t, Tensor mu_t, Tensor cov_t, float thr)"
    " -> (Tensor, Tensor, Tensor, Tensor)",
    lambda *a: update_tail_cuda(*a), lambda *a: update_tail_plain(*a),
    lambda deltas_t, dz_t, nu_t, r_t, mu_t, cov_t, thr: _lanes_outputs(cov_t, mu_t, 1, 1),
    lead=5, adapt=lambda op, *a: op(*a[:-1], float(a[-1])),
)


def _pose_update_lanes(deltas_t, dz_t, nu_t, r_t, mu_t, cov_t, thr):
    m = dz_t.shape[1]
    if not 1 <= m <= MAX_TAIL_M:
        raise ValueError(
            f"the generic-h update tail takes a measurement dimension 1 … {MAX_TAIL_M} "
            f"(MAX_TAIL_M, the kernel's compile-time cap); got m = {m}"
        )
    cuda_lib.route("update_lanes", cov_t)
    return _POSE_UPDATE_TAIL(deltas_t, dz_t, nu_t, r_t, mu_t, cov_t, thr)


def update_model_lanes_cuda(model, z_t, r_t, mu_t, cov_t, scal, aux_t=None, mscal=None):
    """K3 on the card, same operands and outputs as
    :func:`update_model_lanes_plain` (the other half of cov_out is left
    unwritten): one warp per instance, no scratch."""
    m = FUSED_MODELS[model]
    n, nb = TANGENT_DIM, cov_t.shape[-1]
    dev, dtype = cov_t.device, cov_t.dtype
    ops = dict(z_t=z_t, r_t=r_t, mu_t=mu_t, cov_t=cov_t, scal=scal)
    shapes = dict(z_t=(m, nb), r_t=(m, m, nb), mu_t=(STORAGE_DIM, nb), cov_t=(n, n, nb), scal=(6, 1))
    if aux_t is not None:
        ops["aux_t"], shapes["aux_t"] = aux_t, (5, nb)
    if model == "body_efforts":
        if mscal is None:
            raise ValueError("body_efforts needs the shared model-parameter block")
        ops["mscal"], shapes["mscal"] = mscal, (_EFF_NSCAL, 1)
    for key, shape in shapes.items():
        if tuple(ops[key].shape) != shape:
            raise ValueError(f"pose_update_model: {key} has shape {tuple(ops[key].shape)}, expected {shape}")
    empty = lambda *s: torch.empty(s, dtype=dtype, device=dev)
    cov_out, mu_out, m2, acc, nu_t = empty(n, n, nb), empty(STORAGE_DIM, nb), empty(1, nb), empty(1, nb), empty(m, nb)
    cuda_lib.check_lanes("pose_update_model", dev, dtype, cov_out=cov_out, **ops)
    ptr = lambda key: ops[key].data_ptr() if key in ops else None
    cuda_lib.KERNELS["pose_update_model"].launch(
        dtype, MODEL_ID[model], int(aux_t is not None),
        ptr("z_t"), ptr("r_t"), ptr("mu_t"), ptr("cov_t"), ptr("scal"), ptr("mscal"), ptr("aux_t"),
        cov_out.data_ptr(), mu_out.data_ptr(), m2.data_ptr(), acc.data_ptr(), nu_t.data_ptr(), nb,
        cuda_lib.stream_ptr(dev),
    )
    return cov_out, mu_out, m2, acc, nu_t


MODEL_NAMES = tuple(FUSED_MODELS)  # model id → name: the ops take ids, their schemas have no string lists
_POSE_UPDATE_MODEL = cuda_lib.kernel_op(
    "pose_update_model",
    "(int model, Tensor z_t, Tensor r_t, Tensor mu_t, Tensor cov_t, Tensor scal, Tensor? aux_t, Tensor? mscal)"
    " -> (Tensor, Tensor, Tensor, Tensor, Tensor)",
    lambda *a: update_model_lanes_cuda(*a), lambda *a: update_model_lanes_plain(*a),
    lambda model, z_t, r_t, mu_t, cov_t, *rest: _lanes_outputs(cov_t, mu_t, 1, 1, z_t.shape[0]),
    lead=4, **cuda_lib.model_ids(MODEL_NAMES),
)


def _pose_update_model_lanes(model, z_t, r_t, mu_t, cov_t, scal, aux_t=None, mscal=None):
    cuda_lib.route("update_model_lanes", cov_t)
    return _POSE_UPDATE_MODEL(model, z_t, r_t, mu_t, cov_t, scal, aux_t, mscal)


# ---------------------------------------------------------------------------
# operands and public entry points
# ---------------------------------------------------------------------------


def _scal_block(gate_threshold, aux, dtype, device) -> torch.Tensor:
    """(6, 1) operand: [gate threshold (< 0 ⇒ accept any); aux ×5]. Entries
    may be Python numbers or 0-d tensors on ``device``."""
    vals = [-1.0 if gate_threshold is None else gate_threshold, *aux]
    vals += [0.0] * (6 - len(vals))
    return torch.stack(
        [v.to(dtype).reshape(()) if isinstance(v, torch.Tensor) else torch.full((), float(v), dtype=dtype, device=device) for v in vals]
    )[:, None]


def _aux_lanes(aux_bank, nb, dtype) -> torch.Tensor:
    """(5, B) lane operand from a (B, k ≤ 5) per-instance aux array."""
    ab = aux_bank.to(dtype)
    if ab.ndim != 2 or ab.shape[0] != nb or ab.shape[1] > 5:
        raise ValueError(f"aux_bank must be (bank={nb}, k<=5); got {tuple(ab.shape)}")
    return torch.nn.functional.pad(ab, (0, 5 - ab.shape[1])).T.contiguous()


def update_model_lanes(
    model: str, lstate, z, meas_cov, gate_threshold=None, aux: tuple = (), aux_bank=None, mscal=None
):
    """Whole update of an in-kernel measurement model on kernel-layout state.
    ``z`` (B, m); ``meas_cov`` (m, m) or (B, m, m); ``aux`` shared scalars
    or ``aux_bank`` (B, k ≤ 5) per instance, never both. Returns
    ``(LanesBankState, UpdateInfo)``."""
    if aux and aux_bank is not None:
        raise ValueError("pass either shared aux scalars or a per-instance aux_bank, not both")
    dtype, dev = lstate.cov_t.dtype, lstate.cov_t.device
    nb = lstate.cov_t.shape[-1]
    m = FUSED_MODELS[model]
    z_t = z.to(dtype).T.contiguous()
    if z_t.shape != (m, nb):
        raise ValueError(f"{model}: z must be (bank={nb}, {m}); got {tuple(z.shape)}")
    r_t = meas_cov.to(dtype).expand(nb, m, m).permute(1, 2, 0).contiguous()
    aux_t = None if aux_bank is None else _aux_lanes(aux_bank, nb, dtype)
    covo_t, muo_t, m2, acc, nu_t = _pose_update_model_lanes(
        model, z_t, r_t, lstate.mu_t, lstate.cov_t,
        _scal_block(gate_threshold, aux, dtype, dev), aux_t, mscal,
    )
    info = ukf.UpdateInfo(mahalanobis2=m2[0], accepted=acc[0] > 0.5, innovation=nu_t.T)
    return lstate._replace(cov_t=covo_t, mu_t=muo_t), info


def update_model_fused_banked(
    model: str, bstate: "PoseUKFState", z, meas_cov, gate_threshold=None, aux: tuple = (),
    aux_bank=None, mscal=None,
):
    """Bank-first entry of the in-kernel measurement models: pack → one
    launch → unpack."""
    lstate, info = update_model_lanes(
        model, to_lanes(bstate), z, meas_cov, gate_threshold, aux, aux_bank, mscal
    )
    return from_lanes(lstate, bstate), info


def update_velocity_lanes(lstate, params, z, meas_cov, gate_threshold=None):
    """DVL velocity on kernel-layout state (h reads no parameters)."""
    return update_model_lanes("velocity", lstate, z, meas_cov, gate_threshold)


def update_velocity_fused_banked(bstate, params, z, meas_cov, gate_threshold=None):
    return update_model_fused_banked("velocity", bstate, z, meas_cov, gate_threshold)


def update_body_efforts_lanes(lstate, params: "PoseUKFParams", z, meas_cov):
    """Model-aided effort update on kernel-layout state (full mode). Each
    instance's bias- and earth-rate-compensated body rate
    (``getRotationRate`` of its lanes-resident mean) rides the per-instance
    aux lanes of K3 with a shared vehicle model; a banked vehicle model (or
    a banked ``imu_in_body``) takes the generic-h route (K1, ``h`` in
    PyTorch over the banked parameters, K4)."""
    dtype = lstate.cov_t.dtype
    mu = lstate.mu_t
    lat, _ = geo.nav_to_world(params.projection, mu[0], mu[1])
    earth_rot = geo.earth_rotation_nav(lat).to(dtype)  # (B, 3)
    q = mu[3:7].T
    rr_bank = lstate.rr_t.T - mu[13:16].T - mf.quat_rotate_inv(q, earth_rot)
    if params.model.inertia_matrix.ndim == 3 or params.imu_in_body.ndim == 2:
        from .pose_ukf import _EFFORTS_DEPS, _efforts_measurement

        return update_lanes(
            lstate, params, z, meas_cov, lambda chi, rr: _efforts_measurement(chi, params, rr),
            _EFFORTS_DEPS, h_aux=rr_bank,
        )
    return update_model_lanes(
        "body_efforts", lstate, z, meas_cov, aux_bank=rr_bank,
        mscal=_efforts_model_scal(params, dtype),
    )


# ---------------------------------------------------------------------------
# the generic-h route: K1 deltas, h in PyTorch, the K4 tail
# ---------------------------------------------------------------------------


def _field_rows() -> dict:
    """Tangent-row slice of each PoseState field, from ``POSE_MANIFOLD``."""
    from .pose_ukf import POSE_MANIFOLD

    return {f.name: (POSE_MANIFOLD.block(f.name).start, POSE_MANIFOLD.block(f.name).stop)
            for f in POSE_MANIFOLD.fields}


def _measurement_stage(deltas_t, mu_bank, z, deps, h, h_aux=None):
    """``h`` on the sigma points μ ⊞ δ of the fields in ``deps`` (the others
    pinned to the mean, valid because ``deps`` lists every field ``h``
    reads), as JAX's stage of the same name; plain PyTorch, outside any
    kernel. ``h`` maps a PoseState with (107, B, …) fields to (107, B, m);
    with ``h_aux`` it is called as ``h(chi, h_aux)`` and the (B, …) aux
    broadcasts along the bank axis (JAX vmaps it per instance). Returns
    (dZ (107, B, m), innovation (B, m)) about the plain mean of Z."""
    from ..ops import manifolds as mf

    rows = _field_rows()
    unknown = set(deps) - set(rows)
    if unknown:
        raise ValueError(f"deps names unknown PoseState fields: {sorted(unknown)}")
    nsig, nb = deltas_t.shape[0], deltas_t.shape[-1]
    fields = {}
    for name in mu_bank._fields:
        val = getattr(mu_bank, name)
        if name not in deps:
            fields[name] = val.expand(nsig, *val.shape)
            continue
        lo, hi = rows[name]
        d = deltas_t[:, lo:hi].permute(0, 2, 1)  # (107, B, k)
        if name == "orientation":
            fields[name] = mf.so3_boxplus(val, d)
        elif val.ndim == 3:  # mat33, column-major tangent
            fields[name] = val + d.reshape(nsig, nb, 3, 3).transpose(-1, -2)
        else:
            fields[name] = val + d
    chi = mu_bank._replace(**fields)
    Z = (h(chi) if h_aux is None else h(chi, h_aux)).to(deltas_t.dtype)
    z_mean = Z.mean(dim=0)
    return Z - z_mean, z - z_mean


def _pose_state_from_storage(mu_t):
    """(54, B) storage rows → a bank-first PoseState of views."""
    from .pose_ukf import PoseState

    return _unpack_storage(mu_t.T, PoseState(*([None] * len(PoseState._fields))))


def update_lanes(lstate, params, z, meas_cov, h, deps, gate_threshold=None, h_aux=None):
    """Measurement update with a measurement model ``h`` on kernel-layout
    state (``deps`` names the PoseState fields ``h`` reads): K1's sigma
    deltas of the half-valid covariance as it stands, ``h`` in PyTorch
    (:func:`_measurement_stage`), the K4 tail. ``z`` (B, m), ``meas_cov``
    (m, m) or (B, m, m), m ≤ :data:`MAX_TAIL_M`. Returns
    ``(LanesBankState, UpdateInfo)``."""
    del params  # h closes over whatever parameters it reads, as in JAX
    dtype, dev = lstate.cov_t.dtype, lstate.cov_t.device
    nb = lstate.cov_t.shape[-1]
    z = torch.as_tensor(z, dtype=dtype, device=dev)
    m = z.shape[-1]
    if z.shape != (nb, m):
        raise ValueError(f"z must be (bank={nb}, m); got {tuple(z.shape)}")
    r_t = torch.as_tensor(meas_cov, dtype=dtype, device=dev).expand(nb, m, m).permute(1, 2, 0).contiguous()
    deltas_t = sigma_deltas_lanes(lstate.cov_t)
    dz, innovation = _measurement_stage(deltas_t, _pose_state_from_storage(lstate.mu_t), z, deps, h, h_aux)
    thr = -1.0 if gate_threshold is None else float(gate_threshold)
    covo_t, muo_t, m2, acc = _pose_update_lanes(
        deltas_t, dz.permute(0, 2, 1).contiguous(), innovation.T.contiguous(), r_t,
        lstate.mu_t, lstate.cov_t, thr,
    )
    info = ukf.UpdateInfo(mahalanobis2=m2[0], accepted=acc[0] > 0.5, innovation=innovation)
    return lstate._replace(cov_t=covo_t, mu_t=muo_t), info


def update_fused_banked(bstate, params, z, meas_cov, h, deps, gate_threshold=None, h_aux=None):
    """Bank-first entry of the generic-h route: pack → :func:`update_lanes`
    → unpack."""
    lstate, info = update_lanes(to_lanes(bstate), params, z, meas_cov, h, deps, gate_threshold, h_aux)
    return from_lanes(lstate, bstate), info


# ---------------------------------------------------------------------------
# the whole step: predict + a chain of in-kernel updates (K5)
# ---------------------------------------------------------------------------


class StepUpdate(NamedTuple):
    """One measurement of a whole-step chain (:func:`step_lanes`). ``model``
    is one of :data:`STEP_MODELS`; ``aux`` the model's shared scalars, as for
    :func:`update_model_lanes` (``(p_atm, lx, ly, lz)`` for pressure,
    ``(cell_weighting,)`` for water_velocity)."""

    model: str
    z: torch.Tensor  # (B, m)
    meas_cov: torch.Tensor  # (B, m, m) or (m, m)
    gate_threshold: float | None = None
    aux: tuple = ()


def _check_chain(models) -> None:
    if not models:
        raise ValueError("step_lanes needs at least one measurement update")
    if len(models) > MAX_STEP_UPDATES:
        raise ValueError(
            f"the whole-step kernel chains at most {MAX_STEP_UPDATES} updates "
            f"(MAX_STEP_UPDATES, its compile-time cap); got {len(models)}: split the chain "
            "into step_lanes and update_model_lanes calls"
        )
    for model in models:
        if model == "body_efforts":
            raise ValueError(
                "body_efforts reads the vehicle-model block and per-instance rates, which the "
                "whole step does not carry: run it after the step with update_body_efforts_lanes"
            )
        if model not in STEP_MODELS:
            raise ValueError(f"no in-kernel measurement model {model!r}; the step chains {STEP_MODELS}")


def pose_step_lanes_plain(models, cov_t, mu_t, rr_t, coeff, offs, q0m, scal, z_ts, r_ts, scal6):
    """The whole step in PyTorch, operand for operand what K5 computes: K2's
    plain shared-mode predict (coeff/offs (54, 1), q0m (53, 53, 1), scal
    (14, 1)), then K3's plain update for each model in turn on the
    half-valid covariance as it stands, with z_ts[k] (m, B), r_ts[k]
    (m, m, B) and row k of scal6 (n, 6) [threshold; aux ×5]. Returns
    (cov_out half-valid, mu_out, [(m2 (1, B), acc (1, B), nu_t (m, B)), …])."""
    cov, mu = predict_lanes_plain(cov_t, mu_t, rr_t, coeff, offs, q0m, scal)
    infos = []
    for k, model in enumerate(models):
        cov, mu, m2, acc, nu_t = update_model_lanes_plain(model, z_ts[k], r_ts[k], mu, cov, scal6[k][:, None])
        infos.append((m2, acc, nu_t))
    return cov, mu, infos


def pose_step_lanes_cuda(models, cov_t, mu_t, rr_t, coeff, offs, q0m, scal, z_ts, r_ts, scal6):
    """K5 on the card, same operands and outputs as
    :func:`pose_step_lanes_plain` (the other half of cov_out is left
    unwritten)."""
    _check_chain(models)
    n, nb = TANGENT_DIM, cov_t.shape[-1]
    dev, dtype = cov_t.device, cov_t.dtype
    ms = [FUSED_MODELS[model] for model in models]
    ops = dict(cov_t=cov_t, mu_t=mu_t, rr_t=rr_t, coeff=coeff, offs=offs, q0m=q0m, scal=scal, scal6=scal6)
    shapes = dict(cov_t=(n, n, nb), mu_t=(STORAGE_DIM, nb), rr_t=(3, nb), coeff=(STORAGE_DIM, 1),
                  offs=(STORAGE_DIM, 1), q0m=(n, n, 1), scal=(14, 1), scal6=(len(models), 6))
    for k, m in enumerate(ms):
        ops[f"z_t{k}"], shapes[f"z_t{k}"] = z_ts[k], (m, nb)
        ops[f"r_t{k}"], shapes[f"r_t{k}"] = r_ts[k], (m, m, nb)
    for key, shape in shapes.items():
        if tuple(ops[key].shape) != shape:
            raise ValueError(f"pose_step: {key} has shape {tuple(ops[key].shape)}, expected {shape}")
    empty = lambda *s: torch.empty(s, dtype=dtype, device=dev)
    cov_out, mu_out = empty(n, n, nb), empty(STORAGE_DIM, nb)
    infos = [(empty(1, nb), empty(1, nb), empty(m, nb)) for m in ms]
    cuda_lib.check_lanes("pose_step", dev, dtype, cov_out=cov_out, **ops)
    ptrs = lambda ts: cuda_lib.host_array(ctypes.c_void_p, [t.data_ptr() for t in ts])
    chain = (
        cuda_lib.host_array(ctypes.c_int, [MODEL_ID[model] for model in models]),
        ptrs(z_ts), ptrs(r_ts), ptrs([i[0] for i in infos]), ptrs([i[1] for i in infos]),
        ptrs([i[2] for i in infos]),
    )
    models_a, z_a, r_a, m2_a, acc_a, nu_a = (ctypes.addressof(a) for a in chain)
    cuda_lib.KERNELS["pose_step"].launch(
        dtype, *(t.data_ptr() for t in (cov_t, mu_t, rr_t, coeff, offs, q0m, scal)), len(models),
        models_a, z_a, r_a, scal6.data_ptr(), m2_a, acc_a, nu_a, cov_out.data_ptr(), mu_out.data_ptr(), nb,
        cuda_lib.stream_ptr(dev),
    )
    return cov_out, mu_out, infos


_POSE_STEP = cuda_lib.kernel_op(
    "pose_step",
    "(int[] models, Tensor cov_t, Tensor mu_t, Tensor rr_t, Tensor coeff, Tensor offs, Tensor q0m, Tensor scal,"
    " Tensor[] z_ts, Tensor[] r_ts, Tensor scal6) -> (Tensor, Tensor, Tensor[], Tensor[], Tensor[])",
    lambda *a: pose_step_lanes_cuda(*a), lambda *a: pose_step_lanes_plain(*a),
    lambda models, cov_t, mu_t, rr_t, coeff, offs, q0m, scal, z_ts, r_ts, scal6: (
        *_lanes_outputs(cov_t, mu_t), *([cov_t.new_empty(r, cov_t.shape[-1]) for _ in models] for r in (1, 1)),
        [cov_t.new_empty(z.shape) for z in z_ts]),
    lead=1, **cuda_lib.chain(MODEL_NAMES),
)


def _pose_step_lanes(models, cov_t, mu_t, rr_t, coeff, offs, q0m, scal, z_ts, r_ts, scal6):
    cuda_lib.route("step_lanes", cov_t)
    return _POSE_STEP(models, cov_t, mu_t, rr_t, coeff, offs, q0m, scal, z_ts, r_ts, scal6)


def _pad_measurement(z, meas_cov, pad, m, dtype):
    """Neutral pad-lane measurement (z = 0, R = I) for a lanes state wider
    than the bank: finite arithmetic in the pad lanes, gate-accepted, and
    dropped again from the step's infos."""
    if pad:
        z = torch.cat([z, torch.zeros((pad, m), dtype=dtype, device=z.device)])
        eye = torch.eye(m, dtype=dtype, device=z.device).expand(pad, m, m)
        meas_cov = torch.cat([meas_cov, eye])
    return z, meas_cov


def step_lanes(lstate, params: "PoseUKFParams", dt, updates: Sequence[StepUpdate]):
    """One whole filter step — predict(dt) and a chain of measurement
    updates — in one launch of K5 on kernel-layout state, with one shared
    parameter set. Each update draws its sigma points afresh from the
    covariance as it then stands, as the reference's ``predictionStep``
    followed by ``integrateMeasurement`` calls does; the result equals
    :func:`~.pose_fused.predict_lanes` followed by the matching
    :func:`update_model_lanes` calls. The bank is ``updates[0].z.shape[0]``;
    lanes beyond it (a wider state) get the neutral pad measurement. Returns
    ``(LanesBankState, [UpdateInfo, …])`` in update order."""
    updates = [u if isinstance(u, StepUpdate) else StepUpdate(*u) for u in updates]
    _check_chain([u.model for u in updates])
    dtype, dev = lstate.cov_t.dtype, lstate.cov_t.device
    nb_pad = lstate.cov_t.shape[-1]
    nb = updates[0].z.shape[0]
    coeff, offs, q0m, scal = _predict_operands_shared(params, dt, dtype)
    z_ts, r_ts = [], []
    for u in updates:
        m = FUSED_MODELS[u.model]
        z = torch.as_tensor(u.z, device=dev).to(dtype)
        if z.shape[0] != nb:
            raise ValueError(f"inconsistent bank sizes across step updates: {z.shape[0]} vs {nb}")
        if z.shape != (nb, m) or nb > nb_pad:
            raise ValueError(f"{u.model}: z must be (bank={nb} <= {nb_pad} lanes, {m}); got {tuple(z.shape)}")
        meas_cov = torch.as_tensor(u.meas_cov, device=dev).to(dtype).expand(nb, m, m)
        z, meas_cov = _pad_measurement(z, meas_cov, nb_pad - nb, m, dtype)
        z_ts.append(z.T.contiguous())
        r_ts.append(meas_cov.permute(1, 2, 0).contiguous())
    scal6 = torch.cat([_scal_block(u.gate_threshold, u.aux, dtype, dev).T for u in updates]).contiguous()
    cov_t, mu_t, outs = _pose_step_lanes(
        tuple(u.model for u in updates), lstate.cov_t, lstate.mu_t, lstate.rr_t,
        coeff, offs, q0m, scal, z_ts, r_ts, scal6,
    )
    infos = [
        ukf.UpdateInfo(mahalanobis2=m2[0, :nb], accepted=acc[0, :nb] > 0.5, innovation=nu_t.T[:nb])
        for m2, acc, nu_t in outs
    ]
    return lstate._replace(cov_t=cov_t, mu_t=mu_t), infos


def step_velocity_lanes(lstate, params: "PoseUKFParams", dt, z, meas_cov, gate_threshold=None):
    """Predict(dt) and the DVL velocity update in one launch (the
    ``[velocity]`` chain of :func:`step_lanes`). Returns
    ``(LanesBankState, UpdateInfo)``."""
    out, infos = step_lanes(lstate, params, dt, [StepUpdate("velocity", z, meas_cov, gate_threshold)])
    return out, infos[0]

"""The whole BottomUKF step — kernel K7 and its plain version.

Counterpart of ``slam_uwv_kalman_filters_tpu/models/bottom_fused.py``. One
launch per bank computes a whole step of the seafloor tracker
(``src/BottomUKF.cpp``): the 3×3 Cholesky, 7 sigma points, the distance
process model with per-instance speed²·dt²-scaled process noise
(``BottomUKF.cpp:48-54``), the Karcher mean of the sigma normals on S², and
any chain of DVL ray/plane range updates (``BottomUKF.cpp:18-30, 56-61``) and
S²-valued normal observations (``BottomUKF.cpp:63-67``). On a CUDA tensor
:func:`step_lanes` launches ``csrc/bottom_step.cu``; on a CPU tensor it runs
:func:`bottom_step_lanes_plain`.

Both versions compute the same arithmetic, which differs from the generic
path (``models/bottom_ukf.py``) in three places: the S² means run a fixed
``MEAN_ITERS`` = 4 iterations (the generic mean iterates to its tolerance,
at most 64 times); the distance means are taken about the zero sigma point,
d₀ + Σ(dᵢ − d₀)/7; and the S² basis is formed as 2/|v|²·vᵢvⱼ. The sigma set
is ±symmetric about point 0, so the first Karcher correction is nearly exact:
at float64 the two paths agree to ~1e-13 (``tests/test_torch_bottom_ukf.py``
holds them to rtol 1e-9 / atol 1e-11 per step). The gate is a select (a
threshold < 0 accepts any; a NaN S keeps the prior); the log map uses the
native ``atan2``.

Lanes layout, bank last: ``cov_t`` (3, 3, B) in (col, row) order (the lower
half is read, both halves are written), ``mu_t`` (4, B) [distance, normal
xyz], ``vel_t`` (3, B) the cached velocity input. The port does not pad the
bank; :func:`to_lanes` pads on request with the JAX package's convention
(identity covariance, copies of instance 0), pad measurements are the JAX
package's (z = 0 or the unit normal (0, 0, 1), R = I, beams (0, 0, −1) from
the origin), and the lanes functions drop pad lanes from their infos.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, TYPE_CHECKING

import torch

from ..ops import cuda_lib
from ..ops import ukf
from ..ops.linalg_small import _scalar_cholesky_factors
from ..utils.memo import last_operands
from .velocity_fused import _grid, _kalman_tail

if TYPE_CHECKING:
    from .bottom_ukf import BottomUKFParams, BottomUKFState

__all__ = [
    "FUSED_MODELS",
    "MAX_STEP_UPDATES",
    "MEAN_ITERS",
    "BottomLanesState",
    "StepUpdate",
    "to_lanes",
    "from_lanes",
    "set_velocity_lanes",
    "predict_lanes",
    "update_model_lanes",
    "step_lanes",
    "bottom_step_lanes_cuda",
    "bottom_step_lanes_plain",
    "predict_fused_banked",
    "update_model_fused_banked",
]

DOF = 3  # distance (1) + normal (S², 2 DOF), BottomUKF.hpp:15-21
NSIG = 2 * DOF + 1  # 7
MEAN_ITERS = 4  # fixed Karcher iterations (kBotMeanIters)
# in-kernel measurement models → measurement dimension; the position is the
# kernel's model id (csrc/bottom_step.cu)
FUSED_MODELS = {"range": 1, "normal": 2}
MODEL_ID = {name: i for i, name in enumerate(FUSED_MODELS)}
# longest update chain of K7 (kBotMaxSteps, a compile-time cap)
MAX_STEP_UPDATES = 8


class BottomLanesState(NamedTuple):
    """BottomUKF bank in kernel layout."""

    cov_t: torch.Tensor  # (3, 3, B) covariance, (col, row, B)
    mu_t: torch.Tensor  # (4, B) distance, normal xyz
    vel_t: torch.Tensor  # (3, B) cached vehicle-velocity input


def to_lanes(state: "BottomUKFState", lanes: int | None = None) -> BottomLanesState:
    """Bank-first state → kernel layout; ``lanes`` > bank pads with identity
    covariances and copies of instance 0."""
    nb = state.cov.shape[0]
    pad = 0 if lanes is None else lanes - nb
    if pad < 0:
        raise ValueError(f"lanes={lanes} is narrower than the bank ({nb})")
    cov = state.cov
    mu = torch.cat([state.mu.distance, state.mu.normal], dim=-1)
    vel = state.velocity
    if pad:
        cov = torch.cat([cov, torch.eye(DOF, dtype=cov.dtype, device=cov.device).expand(pad, DOF, DOF)])
        tile = lambda a: torch.cat([a, a[:1].expand(pad, a.shape[1])])
        mu, vel = tile(mu), tile(vel)
    return BottomLanesState(cov_t=cov.permute(2, 1, 0).contiguous(), mu_t=mu.T.contiguous(), vel_t=vel.T.contiguous())


def from_lanes(lstate: BottomLanesState, like: "BottomUKFState") -> "BottomUKFState":
    """Kernel layout → bank-first state shaped like ``like`` (pad lanes
    dropped)."""
    nb = like.cov.shape[0]
    mu = lstate.mu_t.T[:nb]
    return like._replace(
        mu=like.mu._replace(distance=mu[:, 0:1], normal=mu[:, 1:4]),
        cov=lstate.cov_t.permute(2, 1, 0)[:nb],
        velocity=lstate.vel_t.T[:nb],
    )


def set_velocity_lanes(lstate: BottomLanesState, velocity) -> BottomLanesState:
    """Cache a new (B, 3) velocity input (``setVelocity``,
    ``BottomUKF.cpp:69-72``); pad lanes repeat instance 0."""
    v = torch.as_tensor(velocity, device=lstate.vel_t.device).to(lstate.vel_t.dtype)
    pad = lstate.vel_t.shape[-1] - v.shape[0]
    if pad:
        v = torch.cat([v, v[:1].expand(pad, 3)])
    return lstate._replace(vel_t=v.T.contiguous())


@last_operands
def _process_noise_scalars(params: "BottomUKFParams", dt, dtype) -> tuple:
    """The nine scalars of ½(Q + Qᵀ), row-major, as host floats (K7 takes
    them by value). Reading Q waits for the card once; the tuple is kept for
    the next call with the same parameters (:func:`~..utils.memo.last_operands`)."""
    q = params.process_noise
    if q.shape != (3, 3):
        raise ValueError(f"the BottomUKF step kernel takes one shared (3, 3) process noise, got {tuple(q.shape)}; "
                         "a banked sweep runs on the generic path (bottom_ukf.predict_bank)")
    q = q.detach().to("cpu", torch.float64)
    return tuple((0.5 * (q + q.T)).reshape(9).tolist())


# ---------------------------------------------------------------------------
# the plain version: each quantity a (B,) lane vector (or (7, B) over the
# sigma points), as the kernel's thread
# ---------------------------------------------------------------------------


def _seq_sum(rows):
    """Σ over the leading axis in order, as the kernel accumulates."""
    acc = torch.zeros_like(rows[0])
    for r in rows:
        acc = acc + r
    return acc


def _s2_basis(x):
    """Householder tangent basis (b0, b1) at unit vectors x = (x0, x1, x2)."""
    x0, x1, x2 = x
    sign = torch.where(x2 >= 0.0, 1.0, -1.0).to(x2.dtype)
    v0, v1, v2 = sign * x0, sign * x1, sign * x2 - 1.0
    vv = v0 * v0 + v1 * v1 + v2 * v2
    degen = vv < 1e-24
    s = 2.0 / torch.where(degen, torch.ones_like(vv), vv)
    b0 = (1.0 - s * v0 * v0, -s * v0 * v1, -s * v0 * v2)
    b1 = (-s * v1 * v0, 1.0 - s * v1 * v1, -s * v1 * v2)
    pick = lambda c, e: torch.where(degen, e, c)
    return (pick(b0[0], 1.0), pick(b0[1], 0.0), pick(b0[2], 0.0)), (pick(b1[0], 0.0), pick(b1[1], 1.0), pick(b1[2], 0.0))


def _s2_boxplus(x, d0, d1, basis):
    """x ⊞ (d0, d1) in ``basis`` at x, renormalized by 1/sqrt."""
    b0, b1 = basis
    v = [b0[i] * d0 + b1[i] * d1 for i in range(3)]
    t2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
    theta = torch.sqrt(t2)
    small = t2 < 1e-24
    safe = torch.where(small, torch.ones_like(theta), theta)
    sinc = torch.where(small, 1.0 - t2 / 6.0, torch.sin(safe) / safe)
    c = torch.cos(theta)
    w = [c * x[i] + sinc * v[i] for i in range(3)]
    inv = 1.0 / torch.sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2])
    return tuple(inv * wi for wi in w)


def _s2_boxminus(y, x, basis):
    """(d0, d1) = y ⊟ x in ``basis`` at x, with the antipode guard."""
    b0, b1 = basis
    cx = (x[1] * y[2] - x[2] * y[1], x[2] * y[0] - x[0] * y[2], x[0] * y[1] - x[1] * y[0])
    s = torch.sqrt(cx[0] * cx[0] + cx[1] * cx[1] + cx[2] * cx[2])
    d = x[0] * y[0] + x[1] * y[1] + x[2] * y[2]
    theta = torch.atan2(s, d)
    t = [y[i] - d * x[i] for i in range(3)]
    tn = torch.sqrt(t[0] * t[0] + t[1] * t[1] + t[2] * t[2])
    small = tn < 1e-12
    inv = 1.0 / torch.where(small, torch.ones_like(tn), tn)
    u = [torch.where(small, torch.where(d > 0.0, 0.0, b0[i]), t[i] * inv) for i in range(3)]
    v = [theta * ui for ui in u]
    return b0[0] * v[0] + b0[1] * v[1] + b0[2] * v[2], b1[0] * v[0] + b1[1] * v[1] + b1[2] * v[2]


def _s2_karcher_mean(pts):
    """Fixed-iteration mean of the (K, B) point components ``pts`` (K = 7
    here, 25 for the IndirectPoseUKF's bearings), seeded from point 0."""
    m = tuple(p[0] for p in pts)
    inv_k = 1.0 / pts[0].shape[0]
    for _ in range(MEAN_ITERS):
        basis = _s2_basis(m)
        d0, d1 = _s2_boxminus(pts, m, basis)
        m = _s2_boxplus(m, _seq_sum(d0) * inv_k, _seq_sum(d1) * inv_k, basis)
    return m


def _mean_about_first(v):
    """(mean, deviations) of (7, B) values about point 0."""
    v0 = v[0]
    dbar = _seq_sum(v[1:] - v0) * (1.0 / NSIG)
    return v0 + dbar, (v - v0) - dbar


def _sigma(P, n):
    """The 7 sigma points of (n, P): delta rows (3 × (7, B)) and normals."""
    L = _scalar_cholesky_factors(_grid(P))
    zero = torch.zeros_like(n[0])
    drow = [torch.stack([zero] + [v for j in range(DOF) for v in ((L[i][j], -L[i][j]) if j <= i else (zero, zero))])
            for i in range(DOF)]
    return drow, _s2_boxplus(n, drow[1], drow[2], _s2_basis(n))


def bottom_step_lanes_plain(models, do_predict, cov_t, mu_t, vel_t, dt, q9, z_ts, r_ts, dir_ts, org_ts, thrs):
    """The whole step in PyTorch, operand for operand what K7 computes:
    ``models`` names each update (:data:`FUSED_MODELS`), ``dt`` and ``q9``
    (the nine scalars of a symmetric Q, row-major; read only with
    ``do_predict``) are host numbers, z_ts[k] (1 or 3, B), r_ts[k] (m, m, B),
    dir_ts[k] / org_ts[k] (3, B) for a range (else None), thrs[k] the
    threshold (< 0 accepts any). Returns (cov_out (3, 3, B), mu_out (4, B),
    [(m2 (1, B), acc (1, B) as 1.0/0.0, nu_t (m, B)), …])."""
    dtype, dev = cov_t.dtype, cov_t.device
    P = [[cov_t[min(i, j), max(i, j)] for j in range(DOF)] for i in range(DOF)]  # lower half
    dist, n = mu_t[0], (mu_t[1], mu_t[2], mu_t[3])
    if do_predict:
        dt = torch.tensor(float(dt), dtype=dtype, device=dev)
        drow, pts = _sigma(P, n)
        dist, dd = _mean_about_first((dist + drow[0]) - dt * vel_t[2])
        mean_n = _s2_karcher_mean(pts)
        dn = _s2_boxminus(pts, mean_n, _s2_basis(mean_n))
        D = [dd, dn[0], dn[1]]
        qs = (vel_t[0] * vel_t[0] + vel_t[1] * vel_t[1]) * dt * dt
        q = [torch.tensor(float(v), dtype=dtype, device=dev) for v in q9]
        P = [[None] * DOF for _ in range(DOF)]
        for i in range(DOF):
            for j in range(i + 1):
                P[i][j] = P[j][i] = 0.5 * _seq_sum(D[i] * D[j]) + qs * q[3 * i + j]
        n = mean_n
    infos = []
    for model, z_t, r_t, d_t, o_t, thr in zip(models, z_ts, r_ts, dir_ts, org_ts, thrs):
        m = FUSED_MODELS[model]
        drow, pts = _sigma(P, n)
        if model == "range":
            vdn = d_t[0] * pts[0] + d_t[1] * pts[1] + d_t[2] * pts[2]
            num = (-o_t[0]) * pts[0] + (-o_t[1]) * pts[1] + (-(dist + drow[0]) - o_t[2]) * pts[2]
            degen = vdn == 0.0
            h = torch.where(degen, 0.0, num / torch.where(degen, torch.ones_like(vdn), vdn))
            z_mean, dz0 = _mean_about_first(h)
            dz, nu_v = [dz0], [z_t[0] - z_mean]
        else:
            zm = _s2_karcher_mean(pts)
            basis = _s2_basis(zm)
            dz = list(_s2_boxminus(pts, zm, basis))
            nu_v = list(_s2_boxminus((z_t[0], z_t[1], z_t[2]), zm, basis))
        S = [[0.5 * _seq_sum(dz[a] * dz[c]) + r_t[a, c] for c in range(m)] for a in range(m)]
        C = [[0.5 * _seq_sum(drow[i] * dz[a]) for a in range(m)] for i in range(DOF)]
        corr, P, m2, acc = _kalman_tail(P, S, C, nu_v, thr)
        dist = dist + corr[0]
        moved = _s2_boxplus(n, corr[1], corr[2], _s2_basis(n))
        n = tuple(torch.where(acc, a, b) for a, b in zip(moved, n))
        infos.append((m2[None], acc.to(dtype)[None], torch.stack(nu_v)))
    cov_out = torch.stack([torch.stack([P[i][j] for i in range(DOF)]) for j in range(DOF)])
    return cov_out.contiguous(), torch.stack([dist, *n]).contiguous(), infos


def bottom_step_lanes_cuda(models, do_predict, cov_t, mu_t, vel_t, dt, q9, z_ts, r_ts, dir_ts, org_ts, thrs):
    """K7 on the card, same operands and outputs as
    :func:`bottom_step_lanes_plain`."""
    if len(models) > MAX_STEP_UPDATES:
        raise ValueError(f"the BottomUKF step kernel chains at most {MAX_STEP_UPDATES} updates "
                         f"(MAX_STEP_UPDATES, its compile-time cap); got {len(models)}")
    nb = cov_t.shape[-1]
    dev, dtype = cov_t.device, cov_t.dtype
    ops = dict(cov_t=cov_t, mu_t=mu_t, vel_t=vel_t)
    shapes = dict(cov_t=(DOF, DOF, nb), mu_t=(DOF + 1, nb), vel_t=(3, nb))
    for k, model in enumerate(models):
        m = FUSED_MODELS[model]
        ops[f"z_t{k}"], shapes[f"z_t{k}"] = z_ts[k], (3 if model == "normal" else 1, nb)
        ops[f"r_t{k}"], shapes[f"r_t{k}"] = r_ts[k], (m, m, nb)
        if model == "range":
            ops[f"dir_t{k}"], shapes[f"dir_t{k}"] = dir_ts[k], (3, nb)
            ops[f"org_t{k}"], shapes[f"org_t{k}"] = org_ts[k], (3, nb)
    for key, shape in shapes.items():
        if tuple(ops[key].shape) != shape:
            raise ValueError(f"bottom_step: {key} has shape {tuple(ops[key].shape)}, expected {shape}")
    if do_predict and len(q9) != 9:
        raise ValueError(f"bottom_step: q9 needs the 9 scalars of Q, got {len(q9)}")
    empty = lambda *s: torch.empty(s, dtype=dtype, device=dev)
    cov_out, mu_out = empty(DOF, DOF, nb), empty(DOF + 1, nb)
    infos = [(empty(1, nb), empty(1, nb), empty(FUSED_MODELS[model], nb)) for model in models]
    cuda_lib.check_lanes("bottom_step", dev, dtype, cov_out=cov_out, **ops)
    ptrs = lambda ts: cuda_lib.host_array(ctypes.c_void_p, [None if t is None else t.data_ptr() for t in ts])
    chain = (
        cuda_lib.host_array(ctypes.c_double, [float(v) for v in q9] if do_predict else []),
        cuda_lib.host_array(ctypes.c_int, [MODEL_ID[model] for model in models]),
        ptrs(z_ts), ptrs(r_ts), ptrs(dir_ts), ptrs(org_ts), cuda_lib.host_array(ctypes.c_double, [float(t) for t in thrs]),
        ptrs([i[0] for i in infos]), ptrs([i[1] for i in infos]), ptrs([i[2] for i in infos]),
    )
    q_a, models_a, z_a, r_a, dir_a, org_a, thr_a, m2_a, acc_a, nu_a = (ctypes.addressof(a) for a in chain)
    cuda_lib.KERNELS["bottom_step"].launch(
        dtype, int(do_predict), cov_t.data_ptr(), mu_t.data_ptr(), vel_t.data_ptr(), float(dt),
        q_a if do_predict else None, len(models), models_a, z_a, r_a, dir_a, org_a, thr_a, m2_a, acc_a, nu_a,
        cov_out.data_ptr(), mu_out.data_ptr(), nb, cuda_lib.stream_ptr(dev),
    )
    return cov_out, mu_out, infos


MODEL_NAMES = tuple(FUSED_MODELS)  # model id → name: the op takes ids, its schema has no string lists


def _bottom_step_fake(models, do_predict, cov_t, mu_t, vel_t, dt, q9, z_ts, r_ts, dir_ts, org_ts, thrs):
    out = lambda *shape: cov_t.new_empty(shape)
    nb = cov_t.shape[-1]
    return (out(*cov_t.shape), out(*mu_t.shape), [out(1, nb) for _ in models], [out(1, nb) for _ in models],
            [out(FUSED_MODELS[MODEL_NAMES[m]], nb) for m in models])


def _bottom_step_cast(do_predict, cov_t, mu_t, vel_t, dt, q9, z_ts, r_ts, dir_ts, org_ts, thrs):
    return (bool(do_predict), cov_t, mu_t, vel_t, float(dt), [float(v) for v in q9], z_ts, r_ts, dir_ts, org_ts,
            [float(t) for t in thrs])


_BOTTOM_STEP = cuda_lib.kernel_op(
    "bottom_step",
    "(int[] models, bool do_predict, Tensor cov_t, Tensor mu_t, Tensor vel_t, float dt, float[] q9, Tensor[] z_ts,"
    " Tensor[] r_ts, Tensor?[] dir_ts, Tensor?[] org_ts, float[] thrs) -> (Tensor, Tensor, Tensor[], Tensor[], Tensor[])",
    lambda *a: bottom_step_lanes_cuda(*a), lambda *a: bottom_step_lanes_plain(*a), _bottom_step_fake,
    lead=2, **cuda_lib.chain(MODEL_NAMES, _bottom_step_cast),
)


def _bottom_step_lanes(models, do_predict, cov_t, mu_t, vel_t, dt, q9, z_ts, r_ts, dir_ts, org_ts, thrs):
    cuda_lib.route("bottom step_lanes", cov_t)
    return _BOTTOM_STEP(models, do_predict, cov_t, mu_t, vel_t, dt, q9, z_ts, r_ts, dir_ts, org_ts, thrs)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


class StepUpdate(NamedTuple):
    """One measurement of a BottomUKF step chain (:func:`step_lanes`):
    ``range`` with a (B, 1) z and the beam's ``direction`` / ``origin``
    ((B, 3) or shared (3,)); ``normal`` with a (B, 3) unit-vector z (an S²
    measurement)."""

    model: str
    z: torch.Tensor  # (B, 1) range or (B, 3) unit normal
    meas_cov: torch.Tensor  # (B, m, m) or (m, m)
    direction: torch.Tensor | None = None  # range only
    origin: torch.Tensor | None = None  # range only
    gate_threshold: float | None = None


def _run(lstate: BottomLanesState, params, dt, updates, do_predict: bool, nb: int):
    dtype, dev = lstate.cov_t.dtype, lstate.cov_t.device
    nb_pad = lstate.cov_t.shape[-1]
    updates = [u if isinstance(u, StepUpdate) else StepUpdate(*u) for u in updates]
    if len(updates) > MAX_STEP_UPDATES:
        raise ValueError(f"the BottomUKF step chains at most {MAX_STEP_UPDATES} updates "
                         f"(MAX_STEP_UPDATES, the kernel's compile-time cap); got {len(updates)}")
    tensor = lambda x: torch.as_tensor(x, device=dev).to(dtype)
    z_ts, r_ts, dir_ts, org_ts, thrs = [], [], [], [], []
    pad = nb_pad - nb
    for u in updates:
        if u.model not in FUSED_MODELS:
            raise ValueError(f"no in-kernel BottomUKF measurement {u.model!r}; models: {tuple(FUSED_MODELS)}")
        m = FUSED_MODELS[u.model]
        zdim = 3 if u.model == "normal" else 1  # normal measurements are S² vectors
        z = tensor(u.z).reshape(-1, zdim)
        if z.shape[0] != nb or nb > nb_pad:
            raise ValueError(f"inconsistent bank sizes across step updates: {z.shape[0]} vs {nb} "
                             f"({nb_pad} lanes)")
        r = tensor(u.meas_cov).expand(nb, m, m)
        if pad:  # neutral pad-lane measurements, the JAX package's
            fill = torch.zeros((pad, zdim), dtype=dtype, device=dev)
            if u.model == "normal":
                fill[:, 2] = 1.0
            z = torch.cat([z, fill])
            r = torch.cat([r, torch.eye(m, dtype=dtype, device=dev).expand(pad, m, m)])
        z_ts.append(z.T.contiguous())
        r_ts.append(r.permute(1, 2, 0).contiguous())
        if u.model == "range":
            if u.direction is None or u.origin is None:
                raise ValueError("range updates need direction and origin")
            d, o = tensor(u.direction).expand(nb, 3), tensor(u.origin).expand(nb, 3)
            if pad:
                down = torch.zeros((pad, 3), dtype=dtype, device=dev)
                down[:, 2] = -1.0
                d, o = torch.cat([d, down]), torch.cat([o, torch.zeros_like(down)])
            dir_ts.append(d.T.contiguous())
            org_ts.append(o.T.contiguous())
        else:
            dir_ts.append(None)
            org_ts.append(None)
        thrs.append(-1.0 if u.gate_threshold is None else float(u.gate_threshold))
    q9 = _process_noise_scalars(params, dt, dtype) if do_predict else ()
    cov_t, mu_t, outs = _bottom_step_lanes(
        tuple(u.model for u in updates), do_predict, lstate.cov_t, lstate.mu_t, lstate.vel_t,
        float(dt) if do_predict else 0.0, q9, z_ts, r_ts, dir_ts, org_ts, thrs,
    )
    infos = [
        ukf.UpdateInfo(mahalanobis2=m2[0, :nb], accepted=acc[0, :nb] > 0.5, innovation=nu_t.T[:nb])
        for m2, acc, nu_t in outs
    ]
    return lstate._replace(cov_t=cov_t, mu_t=mu_t), infos


def step_lanes(lstate: BottomLanesState, params: "BottomUKFParams", dt, updates: Sequence[StepUpdate] = (),
               *, nb: int | None = None):
    """One whole BottomUKF step — predict(dt) and a chain of range / normal
    updates, each redrawing its sigma points as the reference's sequential
    ``integrateMeasurement`` calls do — in one launch on kernel-layout
    state, with one shared (3, 3) process noise. ``nb`` is the true bank
    (default: the first update's ``z.shape[0]``, else every lane). Returns
    ``(BottomLanesState, [UpdateInfo, …])``."""
    updates = [u if isinstance(u, StepUpdate) else StepUpdate(*u) for u in updates]
    if nb is None:
        nb = updates[0].z.shape[0] if updates else lstate.cov_t.shape[-1]
    return _run(lstate, params, dt, updates, True, nb)


def predict_lanes(lstate: BottomLanesState, params: "BottomUKFParams", dt, *,
                  nb: int | None = None) -> BottomLanesState:
    """The prediction alone (``BottomUKF::predictionStepImpl``) on
    kernel-layout state."""
    return _run(lstate, params, dt, [], True, lstate.cov_t.shape[-1] if nb is None else nb)[0]


def update_model_lanes(model: str, lstate: BottomLanesState, z, meas_cov, direction=None, origin=None,
                       gate_threshold=None):
    """One measurement update (no predict) on kernel-layout state. Returns
    ``(BottomLanesState, UpdateInfo)``."""
    z = torch.as_tensor(z)
    out, infos = _run(lstate, None, None, [StepUpdate(model, z, meas_cov, direction, origin, gate_threshold)],
                      False, z.shape[0])
    return out, infos[0]


def predict_fused_banked(bstate: "BottomUKFState", params: "BottomUKFParams", dt) -> "BottomUKFState":
    """Bank-first prediction: pack → one launch → unpack."""
    return from_lanes(predict_lanes(to_lanes(bstate), params, dt), bstate)


def update_model_fused_banked(model: str, bstate: "BottomUKFState", z, meas_cov, direction=None, origin=None,
                              gate_threshold=None):
    """Bank-first update of ``model``: pack → one launch → unpack."""
    ls, info = update_model_lanes(model, to_lanes(bstate), z, meas_cov, direction, origin, gate_threshold)
    return from_lanes(ls, bstate), info

"""The plain PoseUKF tick that judges the port: a frozen, self-contained copy
of the filter's mathematics in plain PyTorch, written for clarity and not
for speed.

The 53-DOF model-aided AUV filter of the reference library (Arnold &
Medagoda, ICRA 2018; ``PoseUKF.cpp``, ``PoseUKFConfig.hpp``) with the
uwv_dynamic_model vehicle, as the ukfom unscented filter runs it:

* 2n+1 = 107 sigma points X₀ = μ, X = μ ⊞ (±columns of chol(P));
* the mean is the equal-weight mean, iterative on SO(3) from X₀;
* covariances are ½·Σ of outer products of ⊟-deviations;
* an update forms S = ½ΣdZdZᵀ + R, C = ½ΣδdZᵀ, K = C·S⁻¹, and keeps the
  prior where a χ² gate rejects the innovation.

Nothing here imports the port or the JAX package, and nothing takes a value
the port derived: the parameters, the process noise and the per-vehicle
operands are worked out again from the configuration file and the draw.
The state is bank-first: a storage mean (S, 54) in the MTK field order
[position 3, quaternion wxyz 4, velocity 3, acceleration 3, gyro bias 3,
acc bias 3, gravity 1, inertia 9, linear damping 9, quadratic damping 9,
water velocity 2, water velocity below 2, ADCP bias 2, water density 1]
(3×3 fields column-major), a covariance (S, 53, 53) over the tangent of
that order (the quaternion's 4 storage rows become 3), and the cached gyro
rate (S, 3).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

N = 53  # tangent dimension
STORAGE = 54
EARTHW = 7.292115e-5  # earth rotation rate [rad/s]
WGS84_A = 6378137.0
WGS84_E2 = (1.0 / 298.257223563) * (2.0 - 1.0 / 298.257223563)
CHI2_95_2DOF = 5.991  # the ADCP gate
XY_YAW = (0, 1, 5)  # surge, sway and yaw rows of the 6-DOF model

# storage slices
POS, QUAT, VEL, ACC = slice(0, 3), slice(3, 7), slice(7, 10), slice(10, 13)
BG, BA, GRAV = slice(13, 16), slice(16, 19), slice(19, 20)
INERTIA, LIN_D, QUAD_D = slice(20, 29), slice(29, 38), slice(38, 47)
WV, WVB, BADCP, RHO = slice(47, 49), slice(49, 51), slice(51, 53), slice(53, 54)
# tangent rows of the same fields
T_ORI = slice(3, 6)


# ---------------------------------------------------------------------------
# quaternions ([w, x, y, z]) and the state manifold
# ---------------------------------------------------------------------------


def qmul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def qconj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def rotate(q, v):
    """R(q)·v."""
    w, u = q[..., :1], q[..., 1:]
    u, v = torch.broadcast_tensors(u, v)
    t = 2.0 * torch.linalg.cross(u, v, dim=-1)
    return v + w * t + torch.linalg.cross(u, t, dim=-1)


def rotate_inv(q, v):
    return rotate(qconj(q), v)


def qexp(v):
    """Rotation vector → unit quaternion (half-angle), with a series near 0."""
    t2 = (v * v).sum(-1, keepdim=True)
    t = torch.sqrt(t2)
    small = t2 < 1e-12
    safe = torch.where(small, torch.ones_like(t), t)
    s = torch.where(small, 0.5 - t2 / 48.0, torch.sin(0.5 * safe) / safe)
    return torch.cat([torch.cos(0.5 * t), s * v], dim=-1)


def qlog(q):
    """Unit quaternion → rotation vector on the w ≥ 0 hemisphere."""
    q = torch.where(q[..., :1] < 0.0, -q, q)
    w = q[..., :1].clamp(-1.0, 1.0)
    xyz = q[..., 1:]
    n2 = (xyz * xyz).sum(-1, keepdim=True)
    n = torch.sqrt(n2)
    small = n2 < 1e-24
    scale = torch.where(small, 2.0 / w.clamp(min=1e-6),
                        2.0 * torch.atan2(n, w) / torch.where(small, torch.ones_like(n), n))
    return scale * xyz


def quat_matrix(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def boxplus(x, d):
    """Storage (…, 54) ⊞ tangent (…, 53)."""
    x, d = torch.broadcast_tensors(x, torch.nn.functional.pad(d, (0, 1)))
    d = d[..., :N]
    q = qmul(x[..., QUAT], qexp(d[..., T_ORI]))
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.cat([x[..., POS] + d[..., 0:3], q, x[..., 7:] + d[..., 6:]], dim=-1)


def boxminus(a, b):
    """Storage a ⊟ b → tangent (…, 53)."""
    dq = qlog(qmul(qconj(b[..., QUAT]), a[..., QUAT]))
    a, b = torch.broadcast_tensors(a, b)
    dq = dq.expand(*a.shape[:-1], 3)
    return torch.cat([a[..., POS] - b[..., POS], dq, a[..., 7:] - b[..., 7:]], dim=-1)


def manifold_mean(points, tol: float, max_iters: int = 64):
    """Equal-weight mean over the leading (sigma) axis: flat rows in closed
    form, the quaternion by the iterative mean from points[0]."""
    flat = points.mean(0)
    m = points[0, ..., QUAT]
    active = torch.ones(m.shape[:-1] + (1,), dtype=torch.bool, device=m.device)
    for _ in range(max_iters):
        step = qlog(qmul(qconj(m)[None], points[..., QUAT])).mean(0)
        nxt = qmul(m, qexp(step))
        nxt = nxt / torch.linalg.vector_norm(nxt, dim=-1, keepdim=True)
        m = torch.where(active, nxt, m)
        active = active & (torch.linalg.vector_norm(step, dim=-1, keepdim=True) > tol)
        if not bool(active.any()):
            break
    return torch.cat([flat[..., POS], m, flat[..., 7:]], dim=-1)


def sigma_deltas(cov):
    """(S, 53, 53) → (107, S, 53): zero, then ± the columns of chol(P)."""
    lower = torch.linalg.cholesky(cov)
    cols = lower.transpose(-1, -2)  # (S, 53 columns, 53 rows)
    d = torch.stack([cols, -cols], dim=1).reshape(cov.shape[0], 2 * N, N)
    return torch.cat([torch.zeros_like(d[:, :1]), d], dim=1).transpose(0, 1)


def symmetric(m):
    return 0.5 * (m + m.transpose(-1, -2))


# ---------------------------------------------------------------------------
# configuration → parameters (PoseUKFConfig.hpp, setProcessNoiseFromConfig)
# ---------------------------------------------------------------------------


class Vehicle(NamedTuple):
    inertia: torch.Tensor  # (6, 6) or (S, 6, 6), added mass included
    lin_damping: torch.Tensor
    quad_damping: torch.Tensor
    weight: torch.Tensor  # () [N]
    buoyancy: torch.Tensor
    cog: torch.Tensor  # (3,)
    cob: torch.Tensor


class Params(NamedTuple):
    q0: torch.Tensor  # (53, 53) or (S, 53, 53) process noise density
    inv_tau: torch.Tensor  # (54,) −1/τ per storage row (0: no decay)
    rest: torch.Tensor  # (54,) Markov rest point per storage row
    wv_scale: torch.Tensor  # () or (S,)
    p_atm: torch.Tensor  # () or (S,)
    lat0: float
    m_rad: float
    imu_in_body: torch.Tensor  # (3,)
    vehicle: Vehicle


def wgs84_gravity(lat: float, alt: float = 0.0) -> float:
    s2 = math.sin(lat) ** 2
    g0 = 9.7803253359 * (1.0 + 1.931852652458e-3 * s2) / math.sqrt(1.0 - WGS84_E2 * s2)
    return g0 - (3.0877e-6 - 4.4e-9 * s2) * alt + 7.2115e-13 * alt**2


def meridional_radius(lat: float) -> float:
    w = math.sqrt(1.0 - WGS84_E2 * math.sin(lat) ** 2)
    return WGS84_A * (1.0 - WGS84_E2) / w**3


def vehicle_from(spec: dict, dtype, device) -> Vehicle:
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return Vehicle(torch.diag(t(spec["inertia_diag"])), torch.diag(t(spec["lin_damping_diag"])),
                   torch.diag(t(spec["quad_damping_diag"])), t(spec["weight"]), t(spec["buoyancy"]),
                   t(spec["cog"]), t(spec["cob"]))


def xy_yaw(m6):
    idx = list(XY_YAW)
    return m6[..., idx, :][..., :, idx]


def colmajor(m3):
    return m3.transpose(-1, -2).reshape(*m3.shape[:-2], 9)


def initial_mean(cfg: dict, vehicle: Vehicle, position, orientation):
    """Storage mean of the first constructor (zero motion, configured
    biases, WGS-84 gravity, the model's (x, y, ψ) blocks) at (S, 3)
    positions and (S, 4) orientations."""
    s, dtype, dev = position.shape[0], position.dtype, position.device
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=dev).expand(s, -1)
    g = wgs84_gravity(cfg["location"]["latitude"], cfg["location"]["altitude"])
    z = lambda k: torch.zeros(s, k, dtype=dtype, device=dev)
    return torch.cat([
        position, orientation, z(3), z(3),
        t(cfg["rotation_rate"]["bias_offset"]), t(cfg["acceleration"]["bias_offset"]), t([g]),
        t(colmajor(xy_yaw(vehicle.inertia))), t(colmajor(xy_yaw(vehicle.lin_damping))),
        t(colmajor(xy_yaw(vehicle.quad_damping))), z(2), z(2), z(2),
        t([cfg["hydrostatics"]["water_density"]]),
    ], dim=-1)


def _blocks(entries: dict, dtype, device):
    """(53, 53) block-diagonal matrix from {tangent slice: (k, k) block}."""
    m = torch.zeros(N, N, dtype=dtype, device=device)
    for sl, block in entries.items():
        m[sl, sl] = torch.as_tensor(block, dtype=dtype, device=device)
    return m


def _tangent(name):
    return {"pos": slice(0, 3), "ori": slice(3, 6), "vel": slice(6, 9), "acc": slice(9, 12),
            "bg": slice(12, 15), "ba": slice(15, 18), "g": slice(18, 19), "inertia": slice(19, 28),
            "lin": slice(28, 37), "quad": slice(37, 46), "wv": slice(46, 48), "wvb": slice(48, 50),
            "badcp": slice(50, 52), "rho": slice(52, 53)}[name]


def initial_cov(cfg: dict, pos_var: float, rot_var: float, dtype, device):
    d = lambda v: torch.diag(torch.as_tensor(v, dtype=torch.float64))
    eye = lambda k, v: v * torch.eye(k, dtype=torch.float64)
    mnp, wv, hyd = cfg["model_noise_parameters"], cfg["water_velocity"], cfg["hydrostatics"]
    sq = lambda v: [x * x for x in v]
    return _blocks({
        _tangent("pos"): eye(3, pos_var), _tangent("ori"): eye(3, rot_var), _tangent("vel"): eye(3, 1.0),
        _tangent("acc"): eye(3, 10.0), _tangent("bg"): d(sq(cfg["rotation_rate"]["bias_instability"])),
        _tangent("ba"): d(sq(cfg["acceleration"]["bias_instability"])), _tangent("g"): [[0.05**2]],
        _tangent("inertia"): d(sq(mnp["inertia_instability"])),
        _tangent("lin"): d(sq(mnp["lin_damping_instability"])),
        _tangent("quad"): d(sq(mnp["quad_damping_instability"])),
        _tangent("wv"): eye(2, wv["limits"] ** 2), _tangent("wvb"): eye(2, wv["limits"] ** 2),
        _tangent("badcp"): eye(2, wv["adcp_bias_limits"] ** 2),
        _tangent("rho"): [[hyd["water_density_limits"] ** 2]],
    }, dtype, device)


def process_noise(cfg: dict, dt: float, dtype, device):
    """``setProcessNoiseFromConfig``: Euler terms from the maximum jerk, the
    gyro random walk, first-order Markov 2/(τ·dt)·σ² for the rest."""
    d = lambda v: torch.diag(torch.as_tensor(v, dtype=torch.float64))
    sq = lambda v: [x * x for x in v]
    jerk = [0.25 * j for j in cfg["max_jerk"]]
    mnp, wv, hyd = cfg["model_noise_parameters"], cfg["water_velocity"], cfg["hydrostatics"]
    gi, ai = cfg["rotation_rate"], cfg["acceleration"]
    markov = lambda tau, var: (2.0 / (tau * dt)) * var
    eye2 = torch.eye(2, dtype=torch.float64)
    return _blocks({
        _tangent("pos"): 1.5 * dt**4 * d(sq([j / 6.0 for j in jerk])),
        _tangent("vel"): 1.5 * dt**2 * d(sq([0.5 * j for j in jerk])),
        _tangent("acc"): d(sq(jerk)),
        _tangent("ori"): d(sq(gi["randomwalk"])),
        _tangent("bg"): markov(gi["bias_tau"], d(sq(gi["bias_instability"]))),
        _tangent("ba"): markov(ai["bias_tau"], d(sq(ai["bias_instability"]))),
        _tangent("g"): [[1e-12]],
        _tangent("inertia"): markov(mnp["inertia_tau"], d(sq(mnp["inertia_instability"]))),
        _tangent("lin"): markov(mnp["lin_damping_tau"], d(sq(mnp["lin_damping_instability"]))),
        _tangent("quad"): markov(mnp["quad_damping_tau"], d(sq(mnp["quad_damping_instability"]))),
        _tangent("wv"): markov(wv["tau"], wv["limits"] ** 2 * eye2),
        _tangent("wvb"): markov(wv["tau"], wv["limits"] ** 2 * eye2),
        _tangent("badcp"): markov(wv["adcp_bias_tau"], wv["adcp_bias_limits"] ** 2 * eye2),
        _tangent("rho"): [[markov(hyd["water_density_tau"], hyd["water_density_limits"] ** 2)]],
    }, dtype, device)


def make_params(cfg: dict, vehicle_spec: dict, dt: float, dtype, device, draw: Optional[dict] = None) -> Params:
    """Parameters of the filter from the configuration, with an optional
    per-vehicle draw: ``scale`` (S,) on the process noise and the water
    velocity scale, ``p_atm_offset`` (S,) [Pa], ``inertia_scale`` (S,) on
    the 6×6 inertia matrix."""
    vehicle = vehicle_from(vehicle_spec, dtype, device)
    mnp, wv, hyd = cfg["model_noise_parameters"], cfg["water_velocity"], cfg["hydrostatics"]
    rows = torch.zeros(STORAGE, dtype=torch.float64)
    rest = torch.zeros(STORAGE, dtype=torch.float64)
    for sl, tau in ((BG, cfg["rotation_rate"]["bias_tau"]), (BA, cfg["acceleration"]["bias_tau"]),
                    (INERTIA, mnp["inertia_tau"]), (LIN_D, mnp["lin_damping_tau"]),
                    (QUAD_D, mnp["quad_damping_tau"]), (WV, wv["tau"]), (WVB, wv["tau"]),
                    (BADCP, wv["adcp_bias_tau"]), (RHO, hyd["water_density_tau"])):
        rows[sl] = -1.0 / tau
    rest[BG] = torch.tensor(cfg["rotation_rate"]["bias_offset"], dtype=torch.float64)
    rest[BA] = torch.tensor(cfg["acceleration"]["bias_offset"], dtype=torch.float64)
    rest[INERTIA] = colmajor(xy_yaw(vehicle.inertia)).double().cpu()
    rest[LIN_D] = colmajor(xy_yaw(vehicle.lin_damping)).double().cpu()
    rest[QUAD_D] = colmajor(xy_yaw(vehicle.quad_damping)).double().cpu()
    rest[RHO] = hyd["water_density"]
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    q0, wv_scale, p_atm = process_noise(cfg, dt, dtype, device), t(wv["scale"]), t(hyd["atmospheric_pressure"])
    if draw is not None:
        scale = draw["scale"].to(dtype=dtype, device=device)
        q0 = q0 * scale[:, None, None]
        wv_scale = wv_scale * scale
        p_atm = p_atm + draw["p_atm_offset"].to(dtype=dtype, device=device)
        inertia_scale = draw["inertia_scale"].to(dtype=dtype, device=device)
        vehicle = vehicle._replace(inertia=vehicle.inertia * inertia_scale[:, None, None])
    lat0 = cfg["location"]["latitude"]
    return Params(q0=q0, inv_tau=rows.to(dtype=dtype, device=device), rest=rest.to(dtype=dtype, device=device),
                  wv_scale=wv_scale, p_atm=p_atm, lat0=lat0, m_rad=meridional_radius(lat0),
                  imu_in_body=torch.zeros(3, dtype=dtype, device=device), vehicle=vehicle)


# ---------------------------------------------------------------------------
# process model and prediction
# ---------------------------------------------------------------------------


def earth_rate_nav(lat):
    return torch.stack([EARTHW * torch.cos(lat), torch.zeros_like(lat), EARTHW * torch.sin(lat)], dim=-1)


def process_model(x, rr, p: Params, dt: float):
    """``processModel`` on (K, S, 54) sigma points with the (S, 3) gyro rate."""
    lat = p.lat0 + x[..., 0] / p.m_rad
    omega = rotate(x[..., QUAT], rr - x[..., BG]) - earth_rate_nav(lat)
    q = qmul(x[..., QUAT], qexp(omega * dt))
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    rest = x[..., 7:] + dt * p.inv_tau[7:] * (x[..., 7:] - p.rest[7:])
    vel = x[..., VEL] + dt * x[..., ACC]
    return torch.cat([x[..., POS] + dt * x[..., VEL], q, vel, rest[..., 3:]], dim=-1)


def step_noise(mu, p: Params, dt: float):
    """The tick's process noise: the gyro block rotated into the navigation
    frame by the prior orientation, the water-current entries inflated by
    the (1, 1, 10)-weighted speed, all scaled by dt²."""
    s = mu.shape[0]
    q = p.q0.expand(s, N, N).clone()
    rot = quat_matrix(mu[:, QUAT])
    q[:, T_ORI, T_ORI] = rot @ q[:, T_ORI, T_ORI] @ rot.transpose(-1, -2)
    sv = mu[:, VEL] * torch.tensor([1.0, 1.0, 10.0], dtype=mu.dtype, device=mu.device)
    extra = p.wv_scale * (sv * sv).sum(-1) * dt
    idx = torch.arange(46, 50, device=mu.device)
    q[:, idx, idx] += extra[:, None]
    return dt * dt * q


def predict(mu, cov, rr, p: Params, dt: float, tol: float):
    deltas = sigma_deltas(cov)
    y = process_model(boxplus(mu[None], deltas), rr, p, dt)
    mu_y = manifold_mean(y, tol)
    d = boxminus(y, mu_y[None]).permute(1, 0, 2)  # (S, 107, 53)
    cov_y = 0.5 * (d.transpose(1, 2) @ d) + step_noise(mu, p, dt)
    return mu_y, symmetric(cov_y)


# ---------------------------------------------------------------------------
# the vehicle model and the update (the measurement models: ``models/<name>.py``)
# ---------------------------------------------------------------------------


def fossen_efforts(vehicle: Vehicle, acc6, vel6, q):
    """Inverse dynamics τ = M·ν̇ + C(ν)ν + D_lin·ν + D_quad·|ν|ν + g(q)."""
    mv = lambda m, v: (m @ v[..., None])[..., 0]
    cross = lambda a, b: torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)
    v, w = vel6[..., :3], vel6[..., 3:]
    p1 = mv(vehicle.inertia[..., :3, :], vel6)
    p2 = mv(vehicle.inertia[..., 3:, :], vel6)
    coriolis = torch.cat([cross(w, p1), cross(w, p2) + cross(v, p1)], dim=-1)
    damping = mv(vehicle.lin_damping, vel6) + mv(vehicle.quad_damping, vel6.abs() * vel6)
    up = rotate_inv(q, torch.tensor([0.0, 0.0, 1.0], dtype=q.dtype, device=q.device))
    w_, b_ = vehicle.weight[..., None], vehicle.buoyancy[..., None]
    f_ext = up * (b_ - w_)
    tau_ext = cross(vehicle.cog, -up * w_) + cross(vehicle.cob, up * b_)
    restoring = -torch.cat([f_ext, tau_ext], dim=-1)
    return mv(vehicle.inertia, acc6) + coriolis + damping + restoring


def embed(m6, block_cm):
    """The 6×6 model with its (x, y, ψ) block replaced by the column-major
    9-vector ``block_cm``."""
    b = block_cm.reshape(*block_cm.shape[:-1], 3, 3).transpose(-1, -2)
    out = m6.expand(*torch.broadcast_shapes(m6.shape[:-2], b.shape[:-2]), 6, 6).clone()
    for i, r in enumerate(XY_YAW):
        for j, c in enumerate(XY_YAW):
            out[..., r, c] = b[..., i, j]
    return out


def body_rate(mu, rr, p: Params):
    """``getRotationRate``: the gyro rate less the bias and the earth rate."""
    lat = p.lat0 + mu[:, 0] / p.m_rad
    return rr - mu[:, BG] - rotate_inv(mu[:, QUAT], earth_rate_nav(lat))


class UpdateResult(NamedTuple):
    mu: torch.Tensor
    cov: torch.Tensor
    nis: torch.Tensor  # (S,)
    accepted: torch.Tensor  # (S,) bool


def update(mu, cov, model, z, r, p: Params, aux=None, decide=None):
    """Unscented update with the measurement model ``model`` (a module of
    ``models``); ``z`` (S, m), ``r`` (m, m) or (S, m, m). A gated model
    accepts where NIS ≤ its ``GATE``, or where ``decide(nis)`` (given) says
    so."""
    deltas = sigma_deltas(cov)  # (107, S, 53)
    zs = model.h(boxplus(mu[None], deltas), p, aux)  # (107, S, m)
    z_mean = zs.mean(0)
    dz = (zs - z_mean).permute(1, 0, 2)  # (S, 107, m)
    dd = deltas.permute(1, 0, 2)
    s = symmetric(0.5 * (dz.transpose(1, 2) @ dz) + r)
    c = 0.5 * (dd.transpose(1, 2) @ dz)  # (S, 53, m)
    nu = z - z_mean
    sol = torch.linalg.solve(s, torch.cat([c.transpose(1, 2), nu[..., None]], dim=-1))
    gain = sol[..., :-1].transpose(1, 2)
    nis = (nu * sol[..., -1]).sum(-1)
    gate = getattr(model, "GATE", None)
    if gate is None:
        accepted = torch.ones_like(nis, dtype=torch.bool)
    else:
        accepted = nis <= gate if decide is None else decide(nis)
    mu_new = boxplus(mu, (gain @ nu[..., None])[..., 0])
    cov_new = symmetric(cov - gain @ s @ gain.transpose(1, 2))
    a = accepted[:, None]
    return UpdateResult(torch.where(a, mu_new, mu), torch.where(a[..., None], cov_new, cov), nis, accepted)

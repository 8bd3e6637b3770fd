"""The ICRA'18-style survey mission of the fleet Monte-Carlo harness — the
port's own copy of ``examples/icra18_mission.py``'s ``simulate_mission``,
``build_fleet_setup`` and ``monte_carlo_params`` (numpy and torch; nothing
of the example or of the JAX package is imported).

An AUV flies a lawn-mower survey at depth: 100 Hz IMU (any rate here), 5 Hz
DVL, 10 Hz pressure and a χ²-95-gated surface GPS fix every 30 s. The setup
gives clean truth streams; :func:`models.monte_carlo.run_fleet_mission`
draws each instance's sensor noise itself.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import dynamics as dyn
from ..ops import geodesy as geo
from ..parallel.bank import tree_map
from ..utils.config import default_pose_ukf_config
from ..utils.device import resolve_device
from . import pose_ukf as pukf
from .monte_carlo import FleetMissionSpec

__all__ = ["simulate_mission", "build_fleet_setup", "monte_carlo_params"]


def simulate_mission(n, dt, rng, *, speed=0.75, leg_s=40.0, depth=-20.0, g=9.8209,
                     rho=1025.0, p_atm=101325.0, gyro_bias=(2e-5, -1e-5, 1.5e-5),
                     acc_bias=(2e-3, -1e-3, 1e-3), lat0=0.8, lon0=0.15, noise=True):
    """Ground truth and sensor streams (numpy) of an ``n``-tick lawn-mower
    survey in the filter's NWU frame: yaw-only attitude, headings
    alternating 0°/180° with 90° turn legs. ``noise=False`` gives clean
    streams (true biases still applied)."""
    t = np.arange(n) * dt
    yaw_rate = np.zeros(n)
    turn_time = 8.0
    cycle = 2 * (leg_s + turn_time)
    tc = np.mod(t, cycle)
    in_turn1 = (tc >= leg_s) & (tc < leg_s + turn_time)
    in_turn2 = tc >= 2 * leg_s + turn_time
    yaw_rate[in_turn1] = np.pi / turn_time
    yaw_rate[in_turn2] = -np.pi / turn_time
    yaw = np.cumsum(yaw_rate) * dt

    vz = 0.05 * np.sin(2 * np.pi * t / 60.0)
    vel = np.stack([speed * np.cos(yaw), speed * np.sin(yaw), vz], axis=1)
    pos = np.cumsum(vel, axis=0) * dt
    pos[:, 2] += depth
    acc = np.gradient(vel, dt, axis=0)
    quat = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], axis=1)

    def rot_to_body(v):
        """R(q)⁻¹ v for the yaw-only attitude."""
        c, s = np.cos(yaw), np.sin(yaw)
        return np.stack([c * v[:, 0] + s * v[:, 1], -s * v[:, 0] + c * v[:, 1], v[:, 2]], axis=1)

    earthw = 7.292115e-5
    omega_e = np.array([earthw * np.cos(lat0), 0.0, earthw * np.sin(lat0)])
    omega_nav = np.stack([0 * yaw, 0 * yaw, yaw_rate], axis=1)
    gyro = rot_to_body(omega_nav + omega_e[None, :]) + np.asarray(gyro_bias)
    acc_m = rot_to_body(acc + np.array([0.0, 0.0, g])[None, :]) + np.asarray(acc_bias)
    dvl = rot_to_body(vel)
    pressure = (p_atm - pos[:, 2] * g * rho)[:, None]
    if noise:
        gyro = gyro + rng.normal(scale=2e-5, size=(n, 3))
        acc_m = acc_m + rng.normal(scale=2e-3, size=(n, 3))
        dvl = dvl + rng.normal(scale=2e-3, size=(n, 3))
        pressure = pressure + rng.normal(scale=50.0, size=(n, 1))
    return dict(t=t, pos=pos, vel=vel, quat=quat, yaw=yaw, gyro=gyro, acc=acc_m,
                dvl=dvl, pressure=pressure, lat0=lat0, lon0=lon0, g=g, rho=rho, p_atm=p_atm)


def build_fleet_setup(minutes=1.0, rate=100.0, dtype_name="f32", seed=0, device=None):
    """(state, params, FleetMissionSpec) of the mission: clean truth streams,
    DVL 5 Hz, pressure 10 Hz, a gated surface fix every 30 s, the noise
    sigmas of the solo replay. ``device=None`` builds on the card."""
    device = resolve_device(device)
    dtype = torch.float64 if dtype_name == "f64" else torch.float32
    dt = 1.0 / rate
    n = int(minutes * 60 * rate)
    sim = simulate_mission(n, dt, np.random.default_rng(seed), noise=False)
    t = lambda a: torch.as_tensor(np.asarray(a), device=device).to(dtype)
    eye = lambda k: torch.eye(k, dtype=dtype, device=device)
    state, params = pukf.init_from_pose(
        t(sim["pos"][0]), eye(3) * 0.25, t(sim["quat"][0]), eye(3) * 1e-4,
        default_pose_ukf_config(), dyn.default_uwv_parameters(dtype=dtype, device=device),
        imu_delta_t=dt, dtype=dtype, device=device,
    )
    every = lambda hz: torch.as_tensor((np.arange(n) % max(1, int(round(rate / hz)))) == 0, device=device)
    # clean surface fixes: the truth through the filter's own projection (the
    # anchor cancels); noise sigma 1.5 m in radians
    proj = params.projection
    lat, lon = geo.nav_to_world(proj, t(sim["pos"][:, 0]), t(sim["pos"][:, 1]))
    spec = FleetMissionSpec(
        dt=dt,
        gyro=t(sim["gyro"]),
        acc=t(sim["acc"]),
        dvl=t(sim["dvl"]),
        pressure=t(sim["pressure"]),
        truth_pos=t(sim["pos"]),
        dvl_valid=every(5.0),
        pressure_valid=every(10.0),
        gyro_sigma=2e-5,
        acc_sigma=2e-3,
        dvl_sigma=2e-3,
        pressure_sigma=50.0,
        acc_cov=eye(3) * (2e-3) ** 2 * 4,
        dvl_cov=eye(3) * (2e-3) ** 2 * 4,
        pressure_cov=eye(1) * 50.0**2 * 4,
        gps=torch.stack([lat, lon], dim=-1),
        gps_valid=every(1.0 / 30.0),
        gps_lat_sigma=1.5 / float(proj.m_rad),
        gps_lon_sigma=1.5 / float(proj.n_rad_cos),
        gps_cov=eye(2) * 1.5**2 * 4,
    )
    return state, params, spec


def monte_carlo_params(params, n, dtype, seed=5, scale_sigma=0.2, p_atm_sigma=100.0):
    """The banked Monte-Carlo parameter draw of the fleet accuracy harness:
    every leaf banked (``n`` instances), ±``scale_sigma`` process-noise and
    water-velocity-scale factors and a ±``p_atm_sigma`` Pa atmospheric
    pressure offset per instance, drawn from a numpy Generator as the
    example draws them."""
    rng = np.random.default_rng(seed)
    dev = params.process_noise.device
    scales = torch.as_tensor(1.0 + scale_sigma * rng.standard_normal(n).clip(-0.9, 0.9), device=dev).to(dtype)
    bp = tree_map(lambda x: x.expand(n, *x.shape), params)
    return bp._replace(
        process_noise=bp.process_noise * scales[:, None, None],
        water_velocity_scale=bp.water_velocity_scale * scales,
        atmospheric_pressure=bp.atmospheric_pressure
        + torch.as_tensor(rng.normal(scale=p_atm_sigma, size=n), device=dev).to(dtype),
    )

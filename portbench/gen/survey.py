"""Traffic of the ``survey`` kind: one simulated lawn-mower survey at depth,
seen by a bank of vehicles whose sensor streams carry their own noise.

The truth (:func:`simulate_truth`) is a copy of the ICRA'18-style survey
simulator of the fleet Monte-Carlo harness (yaw-only attitude, headings
alternating 0°/180° with 180° turns, a slow heave), extended with a slowly
turning water current, the ADCP reading it implies and the body efforts the
vehicle's inverse dynamics give for the truth (a frozen copy of the Fossen
model in ``portbench/reference``). :func:`make_streams` draws each
vehicle's noisy streams on the device from a ``torch.Generator``, one call
per stream, in a fixed order, so that a seed gives the same streams on any
run of the same shapes. Every parameter comes from the traffic file, whose
``updates`` name the streams, their ticks and their noise, in the order the
program applies them; a stream is read from the truth by its name.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import pose_ukf as ref

def simulate_truth(mix: dict, cfg: dict, vehicle_spec: dict) -> dict:
    """Noise-free truth and sensor readings (numpy float64) of
    ``mix["stream_ticks"]`` ticks."""
    n, dt, sv = mix["stream_ticks"], mix["dt"], mix["survey"]
    lat0 = cfg["location"]["latitude"]
    g = ref.wgs84_gravity(lat0, cfg["location"]["altitude"])
    rho, p_atm = cfg["hydrostatics"]["water_density"], cfg["hydrostatics"]["atmospheric_pressure"]
    t = np.arange(n) * dt
    leg, turn = sv["leg_s"], sv["turn_s"]
    tc = np.mod(t, 2 * (leg + turn))
    yaw_rate = np.zeros(n)
    yaw_rate[(tc >= leg) & (tc < leg + turn)] = math.pi / turn
    yaw_rate[tc >= 2 * leg + turn] = -math.pi / turn
    yaw = np.cumsum(yaw_rate) * dt
    vz = sv["heave_mps"] * np.sin(2 * math.pi * t / sv["heave_period_s"])
    vel = np.stack([sv["speed"] * np.cos(yaw), sv["speed"] * np.sin(yaw), vz], axis=1)
    pos = np.cumsum(vel, axis=0) * dt
    pos[:, 2] += sv["depth"]
    acc = np.gradient(vel, dt, axis=0)
    quat = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], axis=1)
    c, s = np.cos(yaw), np.sin(yaw)
    to_body = lambda v: np.stack([c * v[:, 0] + s * v[:, 1], -s * v[:, 0] + c * v[:, 1], v[:, 2]], axis=1)
    earth = np.array([ref.EARTHW * math.cos(lat0), 0.0, ref.EARTHW * math.sin(lat0)])
    omega_body = to_body(np.stack([0 * yaw, 0 * yaw, yaw_rate], axis=1))
    cur = mix["current"]
    phase = 2 * math.pi * t / cur["period_s"]
    current = np.stack([cur["mean"][0] + cur["amplitude"] * np.sin(phase),
                        cur["mean"][1] + cur["amplitude"] * np.cos(phase), 0 * t], axis=1)
    rel_body = to_body(vel - current)
    # the truth through the vehicle's inverse dynamics (frozen Fossen model)
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64)
    vehicle = ref.vehicle_from(vehicle_spec, torch.float64, "cpu")
    acc6 = torch.cat([f64(to_body(acc)), torch.zeros(n, 3, dtype=torch.float64)], dim=1)
    vel6 = torch.cat([f64(rel_body), f64(omega_body)], dim=1)
    efforts = ref.fossen_efforts(vehicle, acc6, vel6, f64(quat)).numpy()
    return dict(
        pos=pos, vel=vel, quat=quat,
        gyro=to_body(np.stack([0 * yaw, 0 * yaw, yaw_rate], axis=1) + earth[None]) + np.asarray(sv["gyro_bias"]),
        acceleration=to_body(acc + np.array([0.0, 0.0, g])[None]) + np.asarray(sv["acc_bias"]),
        velocity=to_body(vel),
        pressure=(p_atm - pos[:, 2] * g * rho)[:, None],
        water_velocity=rel_body[:, :2],
        body_efforts=efforts,
    )


def fires(update: dict, j: int):
    """Index of stream tick ``j`` in the update's stacked readings, or None
    where its stream is silent at ``j``."""
    if j % update["every"] != update["at"]:
        return None
    return j // update["every"]


def make_streams(mix: dict, truth: dict, bank: int, gen: torch.Generator, dtype, device) -> dict:
    """Per-vehicle readings on the device: ``gyro`` (T, B, 3) every tick and
    each scheduled stream (T_k, B, m) on its own ticks, truth plus noise."""
    n = mix["stream_ticks"]

    def draw(name, ticks, sigma):
        base = torch.as_tensor(truth[name][ticks], dtype=dtype, device=device)
        sig = torch.as_tensor(sigma, dtype=dtype, device=device)
        eps = torch.randn((len(ticks), bank, base.shape[-1]), generator=gen, dtype=dtype, device=device)
        return eps.mul_(sig).add_(base[:, None, :])

    out = {"gyro": draw("gyro", np.arange(n), mix["gyro_noise"])}
    for u in mix["updates"]:
        out[u["stream"]] = draw(u["stream"], np.arange(u["at"], n, u["every"]), u["noise"])
    return out


def make_start(mix: dict, cfg: dict, vehicle_spec: dict, truth: dict, bank: int, gen: torch.Generator, device):
    """Perturbed starts: (B, 54) storage means in float64, each vehicle's
    position and heading drawn about the truth from the initial
    covariance, and the (53, 53) initial covariance."""
    st = mix["start"]
    f64 = torch.float64
    pos = torch.as_tensor(truth["pos"][0], dtype=f64, device=device)
    pos = pos + math.sqrt(st["pos_var"]) * torch.randn((bank, 3), generator=gen, dtype=f64, device=device)
    q0 = torch.as_tensor(truth["quat"][0], dtype=f64, device=device).expand(bank, 4)
    dq = math.sqrt(st["rot_var"]) * torch.randn((bank, 3), generator=gen, dtype=f64, device=device)
    q = ref.qmul(q0, ref.qexp(dq))
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    vehicle = ref.vehicle_from(vehicle_spec, f64, device)
    mu = ref.initial_mean(cfg, vehicle, pos, q)
    cov = ref.initial_cov(cfg, st["pos_var"], st["rot_var"], f64, device)
    return mu, cov


def make_draw(draw: dict, bank: int, gen: torch.Generator, device) -> dict:
    """The Monte-Carlo parameter draw of the fleet harness: one clipped
    normal factor on process noise and water-velocity scale, an offset on
    the atmospheric pressure, a clipped normal factor on the vehicle's
    inertia matrix, each per vehicle (float64)."""
    f64 = torch.float64
    clip = draw["clip"]
    factor = lambda sigma: 1.0 + sigma * torch.randn(bank, generator=gen, dtype=f64, device=device).clamp(-clip, clip)
    scale = factor(draw["scale_sigma"])
    p_atm = draw["p_atm_sigma"] * torch.randn(bank, generator=gen, dtype=f64, device=device)
    return {"scale": scale, "p_atm_offset": p_atm, "inertia_scale": factor(draw["inertia_sigma"])}


def measurement_covs(mix: dict) -> dict:
    """The filter's measurement covariance of each stream, (m, m) float64."""
    return {u["stream"]: torch.diag(torch.as_tensor(u["meas_var"], dtype=torch.float64)) for u in mix["updates"]}

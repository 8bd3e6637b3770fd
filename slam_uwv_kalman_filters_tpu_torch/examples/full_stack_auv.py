"""The four-filter AUV estimation stack on the port: every filter, one dive.

The counterpart of ``examples/full_stack_auv.py``: all four of the
reference's filters, each one instance, on one synthetic dive at constant
surge over a sloping seafloor:

* **VelocityUKF**: body velocity from thruster efforts and gyro (its process
  model is the Fossen dynamics), corrected by DVL and pressure;
* **BottomUKF**: seafloor distance and normal from four slanted DVL beam
  ranges, fed the VelocityUKF's velocity rotated by the PoseUKF's attitude;
* **PoseUKF**: the 53-DOF model-aided inertial filter fusing IMU, DVL,
  pressure and body efforts;
* **IndirectPoseUKF**: the error-state corrector between the PoseUKF pose
  and a visual-marker fix every 5 s, giving the corrected pose.

Each runs its generic solo functions (``ops.ukf``: K1 for the PoseUKF's
sigma points on the card; the small filters' factors are unrolled). A tick
without a DVL sample skips the DVL updates where the JAX example selects the
prior with ``jnp.where``: the same result. The script holds the four filters
to the JAX example's checks.

Run:
    python -m slam_uwv_kalman_filters_tpu_torch.examples.full_stack_auv              # the card, float32
    python -m slam_uwv_kalman_filters_tpu_torch.examples.full_stack_auv --cpu --seconds 10   # float64
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models import bottom_ukf as bukf
from ..models import indirect_pose_ukf as iukf
from ..models import pose_ukf as pukf
from ..models import velocity_ukf as vukf
from ..ops import dynamics as dyn
from ..ops import manifolds as mf
from ..utils.config import CameraConfiguration, default_pose_ukf_config
from ..utils.device import resolve_device

__all__ = ["SURGE_EFFORT", "TRUE_DEPTH", "SEAFLOOR_D0", "stack_setup", "StackTicks", "dive", "main"]

SURGE_EFFORT = np.array([65.0, 0, 0, 0, 0, 0.0])  # steady v_x = 1 m/s
TRUE_DEPTH = -15.0
SEAFLOOR_D0 = 8.0  # distance below the vehicle at t = 0
G = 9.8209


def _seafloor_normal() -> np.ndarray:
    n = np.array([0.05, 0.0, 1.0])
    return n / np.linalg.norm(n)


def stack_setup(device, dtype, rate: float):
    """The four filters' initial states and parameters, as the JAX example
    builds them: ((vel_state, vel_params), (bot_state, bot_params),
    (pose_state, pose_params), (ind_state, ind_params))."""
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    model = dyn.default_uwv_parameters(dtype=dtype, device=device)
    vel = vukf.init(vukf.VelocityState(velocity=t(np.zeros(3)), z_position=t([TRUE_DEPTH])),
                    torch.eye(4, dtype=dtype, device=device) * 0.1, model)
    bot = bukf.init(bukf.BottomState(distance=t([SEAFLOOR_D0 + 1.0]), normal=t([0.0, 0.0, 1.0])),
                    torch.diag(t([4.0, 0.05, 0.05])))
    eye = torch.eye(3, dtype=dtype, device=device)
    pose = pukf.init_from_pose(
        imu_in_nwu_pos=t([0.0, 0.0, TRUE_DEPTH]), imu_in_nwu_pos_cov=eye * 0.25,
        imu_in_nwu_rot=t([1.0, 0.0, 0.0, 0.0]), imu_in_nwu_rot_cov=eye * 1e-4,
        config=default_pose_ukf_config(), model_parameters=model, imu_delta_t=1.0 / rate, dtype=dtype, device=device,
    )
    ind = iukf.init(position_error_std=t(np.full(3, 1e-3)), orientation_error_std=t(np.full(3, 1e-4)),
                    orientation_error_tau=60.0, dtype=dtype, device=device)
    return vel, bot, pose, ind


class StackTicks:
    """The per-tick pipelines of the JAX example (its jitted
    ``velocity_tick``, ``bottom_tick`` and ``pose_tick``) and the marker
    fix, over the filters' parameters."""

    def __init__(self, vel_params, bot_params, pose_params, ind_params, dt: float, device, dtype):
        t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
        eye = lambda n: torch.eye(n, dtype=dtype, device=device)
        self.vel_params, self.bot_params, self.pose_params, self.ind_params = (vel_params, bot_params, pose_params,
                                                                                ind_params)
        self.dt = dt
        self.r_dvl, self.r_press_v, self.r_press_p, self.r_range = eye(3) * 1e-4, eye(1) * 1e-3, eye(1) * 2500.0, \
            eye(1) * 1e-2
        self.r_acc, self.r_eff = eye(3) * 1e-4, eye(6) * 1e-1
        s, c = np.sin(np.pi / 6), np.cos(np.pi / 6)
        # four Janus beams, 30° from vertical, pointing down
        self.beam_dirs = t([[s, 0, -c], [-s, 0, -c], [0, s, -c], [0, -s, -c]])
        self.zero3 = t(np.zeros(3))
        # a down-looking camera (180° about body x) sighting a 0.5 m seafloor marker
        self.cam = CameraConfiguration()
        self.cam_q, self.cam_p = t([0.0, 1.0, 0.0, 0.0]), t(np.zeros(3))
        self.marker_q = t([1.0, 0.0, 0.0, 0.0])
        self.feature_pos = t([[0.25, 0.25, 0.0], [-0.25, 0.25, 0.0], [-0.25, -0.25, 0.0], [0.25, -0.25, 0.0]])
        self.feature_covs = (eye(2)[None] * 0.25).repeat(4, 1, 1)
        self.marker_pose_cov = eye(6) * 1e-6

    def velocity(self, vs, gyro, efforts, dvl, depth, do_dvl: bool):
        vs = vukf.integrate_gyro(vs, gyro)
        vs = vukf.integrate_body_efforts(vs, efforts)
        vs = vukf.predict(vs, self.vel_params, self.dt)
        if do_dvl:
            vs, _ = vukf.update_dvl(vs, dvl, self.r_dvl)
        vs, _ = vukf.update_pressure(vs, depth, self.r_press_v)
        return vs

    def bottom(self, bs, velocity, ranges, do_ranges: bool):
        bs = bukf.set_velocity(bs, velocity)
        bs = bukf.predict(bs, self.bot_params, self.dt)
        if do_ranges:
            for k in range(4):
                bs, _ = bukf.update_range(bs, ranges[k:k + 1], self.r_range, self.beam_dirs[k], self.zero3)
        return bs

    def pose(self, ps, gyro, acc, dvl, pressure, efforts, do_dvl: bool):
        p = self.pose_params
        ps = pukf.integrate_rotation_rate(ps, gyro)
        ps = pukf.predict(ps, p, self.dt)
        ps, _ = pukf.update_acceleration(ps, p, acc, self.r_acc)
        if do_dvl:
            ps, _ = pukf.update_velocity(ps, p, dvl, self.r_dvl)
        ps, _ = pukf.update_pressure(ps, p, pressure, self.r_press_p)
        ps, _ = pukf.update_body_efforts(ps, p, efforts, self.r_eff)
        return ps

    def project_marker(self, true_q, true_p, marker_p) -> np.ndarray:
        """True-pose pinhole projection of the marker's corners (the
        simulation's side)."""
        cam_nav_q, cam_nav_p = mf.affine_mul(true_q, true_p, self.cam_q, self.cam_p)
        nav_cam_q, nav_cam_p = mf.affine_inv(cam_nav_q, cam_nav_p)
        pixels = []
        for i in range(self.feature_pos.shape[0]):
            f_nav = mf.affine_apply(self.marker_q, marker_p, self.feature_pos[i])
            f_cam = mf.affine_apply(nav_cam_q, nav_cam_p, f_nav).double().cpu().numpy()
            pixels.append([f_cam[0] / f_cam[2] * self.cam.fx + self.cam.cx,
                           f_cam[1] / f_cam[2] * self.cam.fy + self.cam.cy])
        return np.asarray(pixels)

    def marker_fix(self, ind, pose_state, pixels, marker_p):
        ind = iukf.predict(ind, self.ind_params, 5.0)
        ind = iukf.update_pose_reference(ind, pose_state.mu.position, pose_state.mu.orientation)
        ind, _ = iukf.update_markers(ind, pixels, self.feature_covs, self.feature_pos, marker_p, self.marker_q,
                                     self.marker_pose_cov, self.cam, self.cam_p, self.cam_q)
        return ind


def dive(seconds: float, rate: float, seed: int, device, dtype):
    """Replay the dive; returns (final filter states, the truth at the end)."""
    rng = np.random.default_rng(seed)
    dt = 1.0 / rate
    n = int(seconds * rate)
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    (vel_state, vel_params), (bot_state, bot_params), (pose_state, pose_params), (ind_state, ind_params) = \
        stack_setup(device, dtype, rate)
    ticks = StackTicks(vel_params, bot_params, pose_params, ind_params, dt, device, dtype)
    cfg = default_pose_ukf_config()
    rho, p_atm = float(cfg.hydrostatics.water_density), float(cfg.hydrostatics.atmospheric_pressure)
    normal = _seafloor_normal()
    denom = -(ticks.beam_dirs.double().cpu().numpy() @ normal)
    marker_period = int(5.0 * rate)
    v_true = pos_x = dist_true = 0.0
    for k in range(n):
        # surge ground truth: m·v̇ = τ − d_l·v − d_q·v²
        v_true += dt * (65.0 - 40.0 * v_true - 25.0 * v_true**2) / 145.4
        pos_x += dt * v_true
        dist_true = SEAFLOOR_D0 - pos_x * normal[0] / normal[2]

        gyro = t(rng.normal(scale=1e-4, size=3))
        acc = t([0, 0, G] + rng.normal(scale=1e-3, size=3))
        dvl = t([v_true, 0, 0] + rng.normal(scale=2e-3, size=3))
        depth_meas = t([TRUE_DEPTH + rng.normal(scale=0.02)])
        pressure = t([p_atm - TRUE_DEPTH * G * rho + rng.normal(scale=50.0)])
        efforts = t(SURGE_EFFORT + rng.normal(scale=0.5, size=6))
        ranges = t(dist_true / denom + rng.normal(scale=0.05, size=4))  # ray/plane intersection r = d/(−beam·n)

        do_dvl = k % 10 == 0
        vel_state = ticks.velocity(vel_state, gyro, efforts, dvl, depth_meas, do_dvl)
        bot_state = ticks.bottom(bot_state, mf.quat_rotate(pose_state.mu.orientation, vel_state.mu.velocity), ranges,
                                 do_dvl)
        pose_state = ticks.pose(pose_state, gyro, acc, dvl, pressure, efforts, do_dvl)
        if (k + 1) % marker_period == 0:
            true_q, true_p = t([1.0, 0, 0, 0]), t([pos_x, 0.0, TRUE_DEPTH])  # yaw-free truth
            marker_p = t([pos_x, 0.0, TRUE_DEPTH - 6.0])
            pixels = ticks.project_marker(true_q, true_p, marker_p)
            pixels += rng.normal(scale=0.5, size=pixels.shape)
            ind_state = ticks.marker_fix(ind_state, pose_state, t(pixels), marker_p)
    return (vel_state, bot_state, pose_state, ind_state), {"v": v_true, "pos_x": pos_x, "distance": dist_true}


def main(argv=None) -> dict:
    """Run the dive; returns its figures. Raises where a filter breaks the
    JAX example's checks, and, without ``--cpu``, on a machine without a
    card."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--rate", type=float, default=50.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)

    device = torch.device("cpu") if args.cpu else resolve_device(None)
    dtype_name = "f64" if device.type == "cpu" else "f32"  # as the JAX example runs: x64 on the CPU
    dtype = torch.float64 if dtype_name == "f64" else torch.float32
    t0 = time.perf_counter()
    (vel_state, bot_state, pose_state, ind_state), truth = dive(args.seconds, args.rate, args.seed, device, dtype)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    host = lambda x: x.double().cpu().numpy()
    v_est, z_est = float(vel_state.mu.velocity[0]), float(vel_state.mu.z_position[0])
    d_est, nrm = float(bot_state.mu.distance[0]), host(bot_state.mu.normal)
    pose_v, pose_p = host(pose_state.mu.velocity), host(pose_state.mu.position)
    _, corr_p = iukf.corrected_pose(ind_state)  # (orientation, position)
    corr_x = float(corr_p[0])
    v_true, pos_x, dist_true = truth["v"], truth["pos_x"], truth["distance"]
    normal = _seafloor_normal()
    n = int(args.seconds * args.rate)
    print(f"replayed {n} ticks x 4 filters in {wall:.1f}s ({dtype_name})")
    print(f"VelocityUKF: v_x={v_est:.3f} (true {v_true:.3f})  depth={z_est:.2f} (true {TRUE_DEPTH})")
    print(f"BottomUKF:   distance={d_est:.2f} (true {dist_true:.2f})  normal=({nrm[0]:.3f},{nrm[1]:.3f},{nrm[2]:.3f}) "
          f"(true ({normal[0]:.3f},0,{normal[2]:.3f}))")
    print(f"PoseUKF:     |v|err={abs(pose_v[0] - v_true):.3f}  pos_x={pose_p[0]:.2f} (true {pos_x:.2f})")
    print(f"IndirectPoseUKF corrected pose x={corr_x:.2f} (raw PoseUKF err {abs(pose_p[0] - pos_x):.3f} m -> "
          f"corrected err {abs(corr_x - pos_x):.3f} m)")
    finite = all(bool(torch.isfinite(leaf).all()) for s in (vel_state, bot_state, pose_state, ind_state)
                 for leaf in (s.cov, *s.mu))
    checks = {
        "all filters finite": finite,
        "VelocityUKF diverged": abs(v_est - v_true) < 0.02,
        "BottomUKF distance diverged": abs(d_est - dist_true) < 0.3,
        "BottomUKF normal not recovered": abs(nrm[0] - normal[0]) < 0.03,
        "PoseUKF position diverged": abs(pose_p[0] - pos_x) < 0.5,
        "IndirectPoseUKF correction diverged": abs(corr_x - pos_x) < 0.15,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"full stack: {failed}")
    print("FULL STACK OK")
    return {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu", "dtype": dtype_name,
            "ticks": n, "wall_s": wall, "velocity_error_m_s": abs(v_est - v_true),
            "bottom_distance_error_m": abs(d_est - dist_true), "bottom_normal_x_error": float(abs(nrm[0] - normal[0])),
            "pose_position_error_m": float(abs(pose_p[0] - pos_x)), "corrected_position_error_m": abs(corr_x - pos_x),
            "finite": finite}


if __name__ == "__main__":
    main()

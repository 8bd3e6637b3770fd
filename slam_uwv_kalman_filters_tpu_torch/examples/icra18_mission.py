"""ICRA'18-style synthetic survey mission on the port: trajectory accuracy.

The counterpart of ``examples/icra18_mission.py``: an AUV flies a lawn-mower
survey at depth (``models/fleet_setup.simulate_mission``) with a 100 Hz IMU,
5 Hz DVL, 10 Hz pressure and a projected surface XY fix every 30 s, with an
optional DVL dropout window in which the model-aided filter coasts on
inertial and hydrostatic data alone. The script replays the schedule and
reports the absolute trajectory error (ATE RMSE), the final drift and the
heading error against the simulated truth, and holds the ATE to the JAX
package's example test bound (0.10 m; 1.0 m with a dropout).

Routes (``--path``): ``generic`` replays one filter through
``pose_driver.run_trajectory`` (the generic UKF, K1 for its sigma points on
the card); ``lanes`` replays it as a bank of one in the kernels' lanes layout
through ``pose_driver.run_trajectory_bank_lanes`` (K2 and K3 every tick);
``auto`` takes the lanes route on the card in float32 and the generic route
otherwise, as the JAX example does on the TPU. ``--smooth`` also runs the
unscented RTS smoother (``pose_smoother.run_trajectory_smoothed``: the
generic forward pass, then K1 and K8 each backward tick on the card) and
holds its ATE to the same bound.

Run:
    python -m slam_uwv_kalman_filters_tpu_torch.examples.icra18_mission                  # the card, float32
    python -m slam_uwv_kalman_filters_tpu_torch.examples.icra18_mission --smooth --minutes 1
    python -m slam_uwv_kalman_filters_tpu_torch.examples.icra18_mission --cpu --minutes 0.5   # float64
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models import pose_driver, pose_smoother
from ..models import pose_ukf as pukf
from ..models.fleet_setup import simulate_mission
from ..ops import dynamics as dyn
from ..parallel import bank as bankmod
from ..utils import metrics
from ..utils.config import default_pose_ukf_config
from ..utils.device import resolve_device

__all__ = ["parse_args", "mission_setup", "replay", "main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--minutes", type=float, default=3.0, help="mission duration")
    p.add_argument("--rate", type=float, default=100.0, help="IMU tick rate [Hz]")
    p.add_argument("--dtype", choices=["f32", "f64"], default=None, help="default: f32 on the card, f64 on the CPU")
    p.add_argument("--dvl-dropout", default=None, metavar="T0,T1", help="DVL outage window in seconds (e.g. 60,120)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smooth", action="store_true", help="also run the unscented RTS smoother and report its ATE")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (the plain versions of the kernels)")
    p.add_argument("--path", choices=["auto", "generic", "lanes"], default="auto",
                   help="replay route: the generic solo replay or the lanes kernel loop as a bank of one "
                        "(auto: lanes on the card in float32)")
    return p.parse_args(argv)


def mission_setup(minutes: float, rate: float, seed: int, dvl_dropout, device, dtype):
    """(simulated mission, initial state, params, inputs) of the example: the
    JAX example's draws from ``numpy.random.default_rng(seed)`` (the sensor
    noise, then the surface fixes' noise) and its schedule."""
    dt = 1.0 / rate
    n = int(minutes * 60 * rate)
    rng = np.random.default_rng(seed)
    sim = simulate_mission(n, dt, rng)
    eye = torch.eye(3, dtype=dtype, device=device)
    state, params = pukf.init_from_pose(
        imu_in_nwu_pos=torch.as_tensor(sim["pos"][0], dtype=dtype, device=device),
        imu_in_nwu_pos_cov=eye * 0.25,
        imu_in_nwu_rot=torch.as_tensor(sim["quat"][0], dtype=dtype, device=device),
        imu_in_nwu_rot_cov=eye * 1e-4,
        config=default_pose_ukf_config(),
        model_parameters=dyn.default_uwv_parameters(dtype=dtype, device=device),
        imu_delta_t=dt, dtype=dtype, device=device,
    )
    every = lambda hz: (np.arange(n) % max(1, int(round(rate / hz)))) == 0
    dvl_valid = every(5.0)
    if dvl_dropout:
        t0, t1 = (float(x) for x in dvl_dropout.split(","))
        dvl_valid &= ~((sim["t"] >= t0) & (sim["t"] < t1))
    xy = sim["pos"][:, :2] + rng.normal(scale=1.5, size=(n, 2))
    inputs = pose_driver.make_inputs(
        n, dt,
        rotation_rate=sim["gyro"],
        acc=sim["acc"], acc_cov=np.eye(3) * (2e-3) ** 2 * 4, acc_valid=every(100.0),
        dvl=sim["dvl"], dvl_cov=np.eye(3) * (2e-3) ** 2 * 4, dvl_valid=dvl_valid,
        pressure=sim["pressure"], pressure_cov=np.eye(1) * 50.0**2 * 4, pressure_valid=every(10.0),
        xy=xy, xy_cov=np.eye(2) * 1.5**2 * 4, xy_valid=every(1.0 / 30.0),
        dtype=dtype, device=device,
    )
    return sim, state, params, inputs


def replay(state, params, inputs, lanes: bool):
    """The filtered outputs of the mission: the generic solo replay, or the
    lanes kernel loop as a bank of one."""
    if not lanes:
        return pose_driver.run_trajectory(state, params, inputs)[1]
    inputs_b = pose_driver.PoseInputs(*(None if x is None else x[:, None] for x in inputs))
    _, outs = pose_driver.run_trajectory_bank_lanes(bankmod.replicate(state, 1), params, inputs_b)
    return pose_driver.TickOutput(*(None if x is None else x[:, 0] for x in outs))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Run the mission; returns its figures. Raises where the ATE (or the
    smoothed ATE) breaks the bound, and, without ``--cpu``, on a machine
    without a card."""
    args = parse_args(argv)
    device = torch.device("cpu") if args.cpu else resolve_device(None)
    dtype_name = args.dtype or ("f64" if device.type == "cpu" else "f32")
    dtype = torch.float64 if dtype_name == "f64" else torch.float32
    sim, state, params, inputs = mission_setup(args.minutes, args.rate, args.seed, args.dvl_dropout, device, dtype)
    n = inputs.dt.shape[0]
    use_lanes = args.path == "lanes" or (args.path == "auto" and device.type == "cuda" and dtype == torch.float32)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device={name} dtype={dtype_name} ticks={n} ({args.minutes:.1f} min @ {args.rate:.0f} Hz) "
          f"path={'lanes' if use_lanes else 'generic'}")
    if args.dvl_dropout:
        print(f"DVL dropout: [{args.dvl_dropout}) s, coasting on IMU and pressure")

    t0 = time.perf_counter()
    outs = replay(state, params, inputs, use_lanes)
    _sync(device)
    replay_s = time.perf_counter() - t0

    truth = torch.as_tensor(sim["pos"], dtype=dtype, device=device)
    est_pos = outs.position
    q = outs.orientation.double().cpu().numpy()
    est_yaw = 2 * np.arctan2(q[:, 3], q[:, 0])
    ate = float(metrics.ate_rmse(est_pos, truth))
    pos = est_pos.double().cpu().numpy()
    drift = float(np.linalg.norm(pos[-1] - sim["pos"][-1]))
    dist = float(np.sum(np.linalg.norm(np.diff(sim["pos"], axis=0), axis=1)))
    yaw_err = np.degrees(np.abs(np.angle(np.exp(1j * (est_yaw - sim["yaw"])))))
    bound = 1.0 if args.dvl_dropout else 0.10
    print(f"replay wall time: {replay_s:.1f}s ({n / replay_s:.0f} ticks/s)")
    print(f"trajectory length: {dist:.0f} m")
    print(f"ATE RMSE:          {ate:.3f} m  ({100 * ate / dist:.3f}% of distance)")
    print(f"final drift:       {drift:.3f} m  ({100 * drift / dist:.3f}% of distance)")
    print(f"heading error:     mean {yaw_err.mean():.3f}°, max {yaw_err.max():.3f}°")
    figures = {"device": name, "dtype": dtype_name, "path": "lanes" if use_lanes else "generic", "ticks": n,
               "replay_s": replay_s, "ticks_per_s": n / replay_s, "distance_m": dist, "ate_m": ate,
               "drift_m": drift, "heading_error_mean_deg": float(yaw_err.mean()),
               "heading_error_max_deg": float(yaw_err.max()), "ate_bound_m": bound}
    if not ate < bound:
        raise AssertionError(f"ATE {ate:.3f} m breaks the {bound} m bound")

    if args.smooth:
        t1 = time.perf_counter()
        sm = pose_smoother.run_trajectory_smoothed(state, params, inputs)
        _sync(device)
        smooth_s = time.perf_counter() - t1
        s_ate = float(metrics.ate_rmse(sm.smoothed_mu.position, truth))
        f_ate = float(metrics.ate_rmse(sm.filtered_mu.position, truth))
        print(f"smoother wall time: {smooth_s:.1f}s (forward and backward)")
        print(f"smoothed ATE RMSE: {s_ate:.3f} m  ({100 * s_ate / dist:.3f}% of distance; its forward pass "
              f"{f_ate:.3f} m)")
        figures.update(smooth_s=smooth_s, smoothed_ate_m=s_ate, smoother_filtered_ate_m=f_ate)
        if not (np.isfinite(s_ate) and s_ate < bound):
            raise AssertionError(f"smoothed ATE {s_ate:.3f} m breaks the {bound} m bound")
    print("ICRA18 OK")
    return figures


if __name__ == "__main__":
    main()

"""Time the port's host-bound paths on the card: the paths that spend most
of their time in Python and in launches, so that they move with what a call
into a kernel costs the host.

* ``dispatch`` (:func:`dispatch_us`): K5 at bank 1 on the online chain
  (acceleration + velocity), ``calls`` calls straight to the CUDA wrapper
  (``pose_step_lanes_cuda``), through the entry point's dispatcher
  (``pose_update_fused._pose_step_lanes``) and through the op
  ``slam_uwv::pose_step`` (what an exported program calls), in turns direct,
  entry, op, op, entry, direct; each run's host seconds before the closing
  synchronize (the enqueue, under the launch queue's depth), over the calls:
  host µs a call each way.
* ``estimator``: the online estimator example (``--fused-step``, 10 s at
  100 Hz) at banks 128 and 1: real-time factors.
* ``velocity_bank``: 30 K6 steps at bank 65 536
  (``small_kernel_times.velocity_bank``) after a warm one: filter-steps/s.
* ``pose_class`` (:func:`class_run`): 1000 ticks of the ``PoseUKF`` class
  at bank 1, float32: p50 and p99 ms a tick.
* ``icra18``: the ICRA'18 example's lanes replay (1 minute at 100 Hz, a bank
  of one, float32, with its ATE check): ticks/s.

``chip_smoke.py`` calls :func:`dispatch_us` and :func:`class_run`. To compare
two trees, run this module from a copy of each in one call, in the order A,
B, B, A. Prints one JSON line: the card's name and power limit
(``nvidia-smi``), then the figures.

    python -m slam_uwv_kalman_filters_tpu_torch.tools.host_paths
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

DT = 0.01


def dispatch_us(device, calls: int = 500) -> dict:
    """Host µs a K5 call at bank 1 straight to the wrapper (``direct_us``),
    through the entry point (``entry_us``) and through the op (``op_us``)."""
    from ..models import pose_fused as pf
    from ..models import pose_update_fused as puf
    from . import roofline

    bs, params, meas = roofline.mission_bank(1, torch.float32, device)
    ls = pf.to_lanes(bs)
    models = ("acceleration", "velocity")
    args = (ls.cov_t, ls.mu_t, ls.rr_t, *pf._predict_operands_shared(params, DT, torch.float32),
            [meas[k][0].T.contiguous() for k in ("acc", "dvl")],
            [meas[k][1][..., None].expand(3, 3, 1).contiguous() for k in ("acc", "dvl")],
            torch.cat([puf._scal_block(None, (), torch.float32, device).T] * 2).contiguous())
    ids = [puf.MODEL_ID[m] for m in models]
    routes = {"direct": lambda: puf.pose_step_lanes_cuda(models, *args),
              "entry": lambda: puf._pose_step_lanes(models, *args),
              "op": lambda: puf._POSE_STEP.op(ids, *args)}
    us = {name: [] for name in routes}
    for name in ("direct", "entry", "op", "op", "entry", "direct"):
        routes[name]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            routes[name]()
        us[name].append(1e6 * (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return {**{f"{name}_us": sum(v) / len(v) for name, v in us.items()}, "runs": us}


def class_schedule(ticks: int, g0: float, efforts):
    """The class path's measurements at bench.py's mission rates from a true
    path that starts at the filter's pose (1, 2, −3), yaw 0.2 rad, and runs
    at 0.3 m/s along body x while it turns at 0.01 rad/s, with seeded noise:
    acceleration (the centripetal 0.003 m/s² and gravity), DVL, pressure at
    3 m, the vehicle model's efforts for that motion, and a USBL-style XY
    fix of where the vehicle was 1 s before."""
    rng = np.random.default_rng(43)
    t = np.arange(ticks) * DT - 1.0
    yaw = 0.2 + 0.01 * t
    fix = np.stack([1.0 + 30.0 * (np.sin(yaw) - np.sin(0.2)), 2.0 - 30.0 * (np.cos(yaw) - np.cos(0.2))], -1)
    return {
        "acc": np.array([0.0, 0.003, g0]) + rng.normal(scale=0.006, size=(ticks, 3)),
        "dvl": np.array([0.3, 0.0, 0.0]) + rng.normal(scale=0.03, size=(ticks, 3)),
        "press": 101325.0 + 3.0 * g0 * 1027.0 + rng.normal(scale=50.0, size=(ticks, 1)),
        "eff": np.asarray(efforts) + rng.normal(scale=1.0, size=(ticks, 6)),
        "fix": fix + rng.normal(scale=0.3, size=(ticks, 2)),
    }


def class_run(device, dtype, ticks: int):
    """One vehicle through ``pose_ukf.PoseUKF`` on ``device`` in ``dtype``:
    the delayed buffer (2 s, 256 slots) set up, then every tick the rotation
    rate, ``prediction_step``, ``integrate_acceleration``; DVL every 20th
    tick, pressure every 50th, velocity-only body efforts every 10th, a fix
    1 s late through ``integrate_delayed_measurement`` every 200th. Returns
    (final position, final orientation, per-tick ms, fixes found)."""
    from ..models import pose_ukf as pukf
    from ..ops import dynamics as dyn
    from ..utils.config import default_pose_ukf_config
    from . import roofline

    f = pukf.PoseUKF([1.0, 2.0, -3.0], np.eye(3) * 0.01, [np.cos(0.1), 0.0, 0.0, np.sin(0.1)], np.eye(3) * 1e-4,
                     default_pose_ukf_config(), dyn.default_uwv_parameters(device=device), imu_delta_t=DT,
                     imu_in_body_trans=[0.1, 0.0, -0.2], dtype=dtype, device=device)
    model = dyn.default_uwv_parameters(device="cpu")
    efforts = dyn.calc_efforts(model, torch.zeros(6, dtype=torch.float64),
                               torch.tensor([0.3, 0.0, 0.0, 0.0, 0.0, 0.01], dtype=torch.float64),
                               torch.tensor([np.cos(0.1), 0.0, 0.0, np.sin(0.1)], dtype=torch.float64))
    sched = class_schedule(ticks, float(f.mu.gravity[0]), efforts.numpy())
    r = {"acc": np.eye(3) * 4e-5, "dvl": np.eye(3) * 1e-3, "press": np.eye(1) * 2500.0, "eff": np.eye(6),
         "fix": np.eye(2) * 0.09}
    sync = torch.cuda.synchronize if f.sigma.device.type == "cuda" else (lambda: None)
    f.setup_delayed_state_buffer(2.0, 256)
    tick_ms, found = [], []
    sync()
    for k in range(ticks):
        t0 = time.perf_counter()
        f.integrate_rotation_rate([0.0, 0.0, 0.01])
        f.prediction_step(DT)
        f.integrate_acceleration(sched["acc"][k], r["acc"])
        if roofline.DVL_AT(k):
            f.integrate_velocity(sched["dvl"][k], r["dvl"])
        if roofline.PRESS_AT(k):
            f.integrate_pressure(sched["press"][k], r["press"])
        if roofline.EFF_AT(k):
            f.integrate_body_efforts(sched["eff"][k], r["eff"], only_affect_velocity=True)
        if k % 200 == 199:
            found.append(f.integrate_delayed_measurement(sched["fix"][k], r["fix"], 1.0))
        sync()
        tick_ms.append(1e3 * (time.perf_counter() - t0))
    return f.mu.position.double().cpu(), f.mu.orientation.double().cpu(), tick_ms, found


def main() -> dict:
    from ..examples import icra18_mission, online_estimator
    from . import small_kernel_times as skt

    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    out = {"card": card, "dispatch": dispatch_us(device)}
    for nb in (128, 1):
        figures = online_estimator.main(["--bank", str(nb), "--fused-step"])
        out[f"estimator_bank_{nb}_real_time_factor"] = figures["real_time_factor"]
    _, ls, step = skt.velocity_bank(65536, torch.float32, device)
    ls = step(ls)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(30):
        ls = step(ls)
    torch.cuda.synchronize()
    out["velocity_bank_filter_steps_per_s"] = 65536 * 30 / (time.perf_counter() - t0)
    tick_ms = class_run(device, torch.float32, 1000)[2]
    out["pose_class_ms"] = {"p50": float(np.percentile(tick_ms, 50)), "p99": float(np.percentile(tick_ms, 99))}
    out["icra18_lanes_ticks_per_s"] = icra18_mission.main(["--minutes", "1", "--path", "lanes"])["ticks_per_s"]
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

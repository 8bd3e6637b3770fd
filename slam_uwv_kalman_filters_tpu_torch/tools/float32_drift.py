"""How far the plain (generic) path drifts in float32 from its own float64
run, and what the vmapped solo predict pays for its iterative mean: the
figures behind the limits and the design of ``chip_smoke.phase_vmap``.

* ``survey`` (:func:`survey_drift`): the fleet survey
  (``fleet_setup.build_fleet_setup``, 50 Hz) smoothed over a bank of
  trajectories from one start distribution, with each stream's noise per
  trajectory and tick (:func:`survey_inputs`), through
  ``pose_smoother.run_trajectory_smoothed`` in float64 and again in float32
  on the same draws: the largest position and orientation distance of the
  filtered and the smoothed estimates.
* ``velocity`` (:func:`velocity_drift`): the VelocityUKF's vmapped solo
  ``integrate_body_efforts`` and ``predict`` over a perturbed bank
  (``small_kernel_times.velocity_setup``), 100 steps of 0.05 s with new
  efforts a step, float32 against float64: |Δ|/(1 + |ref|) of the velocity,
  the depth and the covariance.
* ``mean_cost`` (:func:`vmapped_predict_ms`): ``vmap_filter(pose_ukf.predict)``
  on a bank of mission states, its iterative mean ending when the whole bank
  has converged (the flag read beneath the vmap levels) against running all
  its iterations, and ``predict_bank`` beside it: ms a call.

Runs on the CPU unless given ``--device cuda``; prints one JSON line.

    python -m slam_uwv_kalman_filters_tpu_torch.tools.float32_drift --survey-bank 32
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..models import fleet_setup, monte_carlo
from ..models import pose_driver as drv
from ..models import pose_smoother as sm
from ..models import pose_ukf as pukf
from ..models import velocity_ukf as vu
from ..ops import manifolds as mf
from ..parallel import bank
from . import roofline
from . import small_kernel_times as skt


def survey_inputs(spec, nb: int, gen: torch.Generator):
    """The fleet survey's schedule for a bank of ``nb`` trajectories, (T, nb,
    …): every stream with its own noise per trajectory and tick, drawn from
    ``gen`` on the spec's device (gyro, acceleration, DVL, pressure, GPS),
    the validity flags of the schedule (DVL 5 Hz, pressure 10 Hz, a fix
    every 30 s)."""
    n, dev, dtype = spec.gyro.shape[0], spec.gyro.device, spec.gyro.dtype
    noisy = lambda clean, sigma: clean[:, None] + float(sigma) * torch.randn(
        n, nb, *clean.shape[1:], generator=gen, dtype=dtype, device=dev)
    cov = lambda c: c.expand(n, nb, *c.shape)
    flag = lambda f: f[:, None].expand(n, nb)
    sigma = torch.tensor([float(spec.gps_lat_sigma), float(spec.gps_lon_sigma)], dtype=dtype, device=dev)
    return drv.PoseInputs(
        dt=torch.full((n, nb), float(spec.dt), dtype=dtype, device=dev),
        rotation_rate=noisy(spec.gyro, spec.gyro_sigma),
        acc=noisy(spec.acc, spec.acc_sigma), acc_cov=cov(spec.acc_cov),
        acc_valid=torch.ones((n, nb), dtype=torch.bool, device=dev),
        dvl=noisy(spec.dvl, spec.dvl_sigma), dvl_cov=cov(spec.dvl_cov), dvl_valid=flag(spec.dvl_valid),
        pressure=noisy(spec.pressure, spec.pressure_sigma), pressure_cov=cov(spec.pressure_cov),
        pressure_valid=flag(spec.pressure_valid),
        xy=None, xy_cov=None, xy_valid=None, adcp=None, adcp_cov=None, adcp_cell_weighting=None, adcp_valid=None,
        efforts=None, efforts_cov=None, efforts_valid=None,
        gps=spec.gps[:, None] + sigma * torch.randn(n, nb, 2, generator=gen, dtype=dtype, device=dev),
        gps_cov=cov(spec.gps_cov), gps_valid=flag(spec.gps_valid),
    )


def _float32(tree):
    return bank.tree_map(lambda a: a.float() if a.is_floating_point() else a, tree)


def survey_drift(nb: int = 32, seconds: float = 10.0, device="cpu", seed: int = 3) -> dict:
    """The smoothed survey's float32 distance from float64 (module notes)."""
    state, params, spec = fleet_setup.build_fleet_setup(minutes=seconds / 60.0, rate=50.0, dtype_name="f64",
                                                        device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    bs = monte_carlo.perturb_initial_bank(bank.replicate(state, nb), gen, pos_sigma=0.05, vel_sigma=0.05,
                                          yaw_sigma=3e-3)
    inputs = survey_inputs(spec, nb, gen)
    ref = sm.run_trajectory_smoothed(bs, params, inputs)
    out = sm.run_trajectory_smoothed(_float32(bs), _float32(params),
                                     drv.PoseInputs(*(None if x is None else _float32(x) for x in inputs)))
    result = {"bank": nb, "ticks": spec.gyro.shape[0]}
    for name in ("filtered", "smoothed"):
        a, b = getattr(out, f"{name}_mu"), getattr(ref, f"{name}_mu")
        result[f"{name}_position_m"] = (a.position.double() - b.position).norm(dim=-1).max().item()
        result[f"{name}_orientation_rad"] = mf.so3_boxminus(a.orientation.double(), b.orientation).norm(
            dim=-1).max().item()
    return result


def velocity_drift(nb: int = 512, steps: int = 100, device="cpu", seed: int = 0) -> dict:
    """The vmapped VelocityUKF predict's float32 distance from float64 (module
    notes)."""
    bs, params = skt.velocity_setup(nb, torch.float64, device, torch.Generator(device=device).manual_seed(seed))
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    efforts = [30.0 * torch.randn(nb, 6, generator=gen, dtype=torch.float64, device=device) for _ in range(steps)]
    integrate = torch.func.vmap(vu.integrate_body_efforts)
    predict = bank.vmap_filter(vu.predict, data_axes=None)
    s64, s32, p32 = bs, _float32(bs), _float32(params)
    for e in efforts:
        s64 = predict(integrate(s64, e), params, 0.05)
        s32 = predict(integrate(s32, e.float()), p32, 0.05)
    rel = lambda a, b: ((a.double() - b).abs() / (1.0 + b.abs())).max().item()
    return {"bank": nb, "steps": steps, "velocity": rel(s32.mu.velocity, s64.mu.velocity),
            "z": rel(s32.mu.z_position, s64.mu.z_position), "cov": rel(s32.cov, s64.cov)}


def vmapped_predict_ms(nb: int = 4, reps: int = 10, device="cpu") -> dict:
    """ms a call of the vmapped solo predict, its mean ending on the bank's
    flag and running all its iterations, and of ``predict_bank`` (module
    notes)."""
    bs, params, _ = roofline.mission_bank(nb, torch.float64, device)
    vpredict = bank.vmap_filter(pukf.predict, data_axes=None)

    def ms(fn):
        fn()
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if device != "cpu":
            torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps

    early = ms(lambda: vpredict(bs, params, 0.01))
    every = mf._run_every_iteration
    mf._run_every_iteration = lambda vals: True
    try:
        all_iterations = ms(lambda: vpredict(bs, params, 0.01))
    finally:
        mf._run_every_iteration = every
    return {"bank": nb, "vmapped_ms": early, "vmapped_all_iterations_ms": all_iterations,
            "predict_bank_ms": ms(lambda: pukf.predict_bank(bs, params, 0.01))}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--survey-bank", type=int, default=32)
    parser.add_argument("--survey-seconds", type=float, default=10.0)
    parser.add_argument("--velocity-bank", type=int, default=512)
    args = parser.parse_args()
    print(json.dumps({"device": args.device,
                      "survey": survey_drift(args.survey_bank, args.survey_seconds, args.device),
                      "velocity": velocity_drift(args.velocity_bank, device=args.device),
                      "mean_cost": vmapped_predict_ms(device=args.device)}))


if __name__ == "__main__":
    main()

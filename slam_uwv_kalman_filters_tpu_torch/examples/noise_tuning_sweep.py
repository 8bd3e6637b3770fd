"""Monte-Carlo noise-tuning sweep on the port: a bank over parameter sets.

The counterpart of ``examples/noise_tuning_sweep.py``. Filter tuning runs the
same trajectory under every candidate noise configuration and keeps the one
whose normalized innovation squared (NIS) is statistically consistent, E[NIS]
≈ m for an m-dimensional measurement. The candidates scale the
acceleration-random-walk block of Q over two orders of magnitude around the
truth; the truth is a sinusoidal surge acceleration seen through noisy DVL
velocities.

JAX's ``jax.vmap(with_scale)`` over parameter sets is here a stacked
parameter bank (every leaf with a leading candidate axis), replayed on the
lanes loop: K2 in its full mode (per-lane operands built once by
``pose_fused.banked_predict_operands``) and K3's DVL update
(``pose_update_fused.update_velocity_lanes``), one Python loop over the ticks
in place of JAX's ``lax.scan``. The script holds the sweep to the JAX
example's check: the best candidate lies inside the grid, or its mean NIS
within 2 of 3.

Run:
    python -m slam_uwv_kalman_filters_tpu_torch.examples.noise_tuning_sweep             # the card, float32
    python -m slam_uwv_kalman_filters_tpu_torch.examples.noise_tuning_sweep --cpu --candidates 6 --seconds 10  # float64
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models import pose_fused as pf
from ..models import pose_ukf as pukf
from ..models import pose_update_fused as puf
from ..ops import dynamics as dyn
from ..parallel import bank as bankmod
from ..utils.config import default_pose_ukf_config
from ..utils.device import resolve_device

__all__ = ["sweep_setup", "sweep", "main"]


def sweep_setup(candidates: int, seconds: float, rate: float, seed: int, device, dtype):
    """(scales, banked params, lanes state, DVL stream (n, 3), DVL covariance)
    of the example, with the JAX example's draws from
    ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    dt = 1.0 / rate
    n = int(seconds * rate)
    eye = torch.eye(3, dtype=dtype, device=device)
    state, params = pukf.init_from_pose(
        imu_in_nwu_pos=torch.zeros(3, dtype=dtype, device=device),
        imu_in_nwu_pos_cov=eye * 0.25,
        imu_in_nwu_rot=torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device),
        imu_in_nwu_rot_cov=eye * 1e-4,
        config=default_pose_ukf_config(),
        model_parameters=dyn.default_uwv_parameters(dtype=dtype, device=device),
        imu_delta_t=dt, dtype=dtype, device=device,
    )
    # the candidate grid: the acceleration block of Q scaled by each factor
    scales = torch.as_tensor(np.logspace(-1.0, 1.0, candidates), dtype=dtype, device=device)
    acc = pukf.POSE_MANIFOLD.block("acceleration")
    mask = torch.zeros((53, 53), dtype=dtype, device=device)
    mask[acc, acc] = 1.0
    params_bank = bankmod.replicate(params, candidates)
    params_bank = params_bank._replace(
        process_noise=params.process_noise * (1.0 + (scales[:, None, None] - 1.0) * mask))

    # the truth: a sinusoidal acceleration the filter must track through its
    # random walk; the DVL innovations expose a mis-tuned Q
    t = np.arange(n) * dt
    acc_true = 0.3 * np.sin(2 * np.pi * t / 5.0)
    vel_true = np.cumsum(acc_true) * dt
    dvl = np.stack([vel_true, 0 * t, 0 * t], axis=1) + rng.normal(scale=2e-3, size=(n, 3))
    dvl = torch.as_tensor(dvl, dtype=dtype, device=device)
    r_dvl = eye * (2e-3) ** 2 * 4
    s0 = pukf.integrate_rotation_rate(state, torch.zeros(3, dtype=dtype, device=device))
    return scales, params_bank, pf.to_lanes(bankmod.replicate(s0, candidates)), dvl, r_dvl


def sweep(ls, params_bank, dvl, r_dvl, dt: float) -> torch.Tensor:
    """Replay the DVL stream on every candidate at once; returns each
    candidate's mean NIS over the ticks."""
    candidates = ls.cov_t.shape[-1]
    banked_ops = pf.banked_predict_operands(params_bank, dt, ls.cov_t.dtype)
    nis = []
    for z in dvl:
        ls = pf.predict_lanes(ls, params_bank, dt, banked_ops=banked_ops)
        # the DVL model reads no parameters: the in-kernel update serves the sweep too
        ls, info = puf.update_velocity_lanes(ls, params_bank, z.expand(candidates, 3), r_dvl)
        nis.append(info.mahalanobis2)
    return torch.stack(nis).mean(dim=0)


def main(argv=None) -> dict:
    """Run the sweep; returns its figures. Raises where the grid does not
    bracket a consistent tuning, and, without ``--cpu``, on a machine
    without a card."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--candidates", type=int, default=8)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rate", type=float, default=25.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (the plain versions of the kernels)")
    args = p.parse_args(argv)

    device = torch.device("cpu") if args.cpu else resolve_device(None)
    dtype_name = "f64" if device.type == "cpu" else "f32"  # as the JAX example runs: x64 on the CPU
    dtype = torch.float64 if dtype_name == "f64" else torch.float32
    scales, params_bank, ls, dvl, r_dvl = sweep_setup(args.candidates, args.seconds, args.rate, args.seed, device,
                                                      dtype)
    t0 = time.perf_counter()
    mean_nis = sweep(ls, params_bank, dvl, r_dvl, 1.0 / args.rate).double().cpu().numpy()
    wall = time.perf_counter() - t0

    # consistency target: E[NIS] = the measurement dimension, 3
    best = int(np.argmin(np.abs(mean_nis - 3.0)))
    scales = scales.double().cpu().numpy()
    print(f"{args.candidates} candidates x {dvl.shape[0]} ticks in {wall:.1f}s ({dtype_name})")
    for i, (sc, nis_i) in enumerate(zip(scales, mean_nis)):
        tag = "  <-- best (closest to E[NIS]=3)" if i == best else ""
        print(f"  Q_acc x {sc:6.2f}: mean NIS = {nis_i:8.3f}{tag}")
    if not (0 < best < args.candidates - 1 or abs(mean_nis[best] - 3.0) < 2.0):
        raise AssertionError("sweep failed to bracket a consistent tuning")
    print(f"TUNING OK: best acceleration-noise scale = {scales[best]:.2f}")
    return {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu", "dtype": dtype_name,
            "candidates": args.candidates, "ticks": int(dvl.shape[0]), "wall_s": wall,
            "mean_nis": mean_nis.tolist(), "scales": scales.tolist(), "best": best, "best_scale": float(scales[best])}


if __name__ == "__main__":
    main()

"""Fleet-scale Monte-Carlo filter bank with elastic recovery, on the port.

The counterpart of ``examples/fleet_monte_carlo.py``: a bank of N
independent PoseUKF instances (a vehicle fleet, a tuning sweep, a parameter
ensemble) is one state tree with a leading bank axis;

* every instance starts from a perturbed initial position (Monte-Carlo over
  initialization error),
* the whole bank steps in lock-step, 100 predictions and a 5 Hz DVL update
  per simulated second (K2 and K3 on the card),
* the bank sits on a 1-D bank mesh (``parallel.sharding``; one rank without
  a process group), and the ensemble statistics (mean, spread, position NEES
  against the truth) reduce over it each second,
* then 1% of the instances are poisoned and ``parallel.failover`` restarts
  them from the last healthy snapshot.

On the card the bank stays in the kernels' lanes layout through each second
(``pose_fused.predict_lanes``, ``pose_update_fused.update_velocity_lanes``);
the bank-first forms convert the layout on every call, and the round trip is
exact, so both give the same bits. On the CPU it takes the bank-first
generic path, as the JAX package does there.

Run:
    python -m slam_uwv_kalman_filters_tpu_torch.examples.fleet_monte_carlo --bank 131072   # one card
    python -m slam_uwv_kalman_filters_tpu_torch.examples.fleet_monte_carlo --bank 256 --seconds 2 --cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models import pose_fused, pose_update_fused
from ..models import pose_ukf as pukf
from ..ops import dynamics as dyn
from ..parallel import bank as bankmod
from ..parallel import failover, sharding
from ..utils import metrics
from ..utils.config import default_pose_ukf_config
from ..utils.device import resolve_device

__all__ = ["fleet_setup", "bank_step", "second_of_steps", "poison", "main"]

DVL_VAR = 1e-4
TRUE_VELOCITY = (0.5, 0.0, 0.0)


def fleet_setup(bank: int, rate: float, seed: int, device, dtype=torch.float32):
    """The example's Monte-Carlo bank: the mission filter (0.5 m position
    and 1e-4 rad² attitude priors at the origin, zero rotation rate)
    replicated ``bank`` times, each instance's position moved by a draw from
    N(0, 0.5²) of ``numpy.random.default_rng(seed)``. Returns (bank state,
    shared params, the generator for later draws)."""
    eye = torch.eye(3, dtype=dtype, device=device)
    state, params = pukf.init_from_pose(
        imu_in_nwu_pos=torch.zeros(3, dtype=dtype, device=device),
        imu_in_nwu_pos_cov=eye * 0.25,
        imu_in_nwu_rot=torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device),
        imu_in_nwu_rot_cov=eye * 1e-4,
        config=default_pose_ukf_config(),
        model_parameters=dyn.default_uwv_parameters(dtype=dtype, device=device),
        imu_delta_t=1.0 / rate, dtype=dtype, device=device,
    )
    state = pukf.integrate_rotation_rate(state, torch.zeros(3, dtype=dtype, device=device))
    rng = np.random.default_rng(seed)
    bstate = bankmod.replicate(state, bank)
    pos_err = torch.as_tensor(rng.normal(scale=0.5, size=(bank, 3)), dtype=dtype, device=device)
    bstate = bstate._replace(mu=bstate.mu._replace(position=bstate.mu.position + pos_err))
    return bstate, params, rng


def bank_step(params, dt: float, meas_cov: torch.Tensor):
    """The heal's bank step ``step(bank, z) -> (bank, UpdateInfo)``: one
    prediction, then the DVL update, bank-first."""

    def step(bs, z):
        return pukf.update_velocity_bank(pukf.predict_bank(bs, params, dt), params, z, meas_cov)

    return step


def second_of_steps(bs, params, z, truth_pos, *, dt: float, n_ticks: int, dvl_every: int, meas_cov):
    """One simulated second: ``n_ticks`` predictions, the DVL update on
    every ``dvl_every``-th, then the ensemble statistics over the mesh:
    (mean position, largest per-axis spread, mean position NEES against
    ``truth_pos``). A CUDA bank runs the second in lanes layout."""
    if bs.cov.device.type == "cuda":
        ls = pose_fused.to_lanes(bs)
        for k in range(n_ticks):
            ls = pose_fused.predict_lanes(ls, params, dt)
            if k % dvl_every == 0:
                ls, _ = pose_update_fused.update_velocity_lanes(ls, params, z, meas_cov)
        bs = pose_fused.from_lanes(ls, bs)
    else:
        for k in range(n_ticks):
            bs = pukf.predict_bank(bs, params, dt)
            if k % dvl_every == 0:
                bs, _ = pukf.update_velocity_bank(bs, params, z, meas_cov)
    mean_pos, pos_cov = sharding.ensemble_moments(bs.mu.position)
    spread = torch.sqrt(torch.diagonal(pos_cov)).max()
    mean_nees = sharding.ensemble_mean(metrics.nees(bs.mu.position - truth_pos, bs.cov[:, :3, :3]))
    return bs, (mean_pos, spread, mean_nees)


def poison(bstate, rng: np.random.Generator):
    """NaN the forward velocity of 1% of the instances (at least one),
    drawn without replacement: a simulated bad sensor burst. Returns the
    poisoned bank and the instances' indices."""
    nb = bstate.cov.shape[0]
    dead_idx = rng.choice(nb, size=max(1, nb // 100), replace=False)
    vel = bstate.mu.velocity.clone()
    vel[torch.as_tensor(dead_idx, device=vel.device), 0] = float("nan")
    return bstate._replace(mu=bstate.mu._replace(velocity=vel)), dead_idx


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Run the example; returns its figures. Raises where the bank diverges
    or the heal leaves a dead instance, and, without ``--cpu``, on a
    machine without a card."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--bank", type=int, default=8192)
    p.add_argument("--seconds", type=float, default=10.0, help="simulated mission time")
    p.add_argument("--rate", type=float, default=100.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    device = torch.device("cpu") if args.cpu else resolve_device(None)
    dtype = torch.float32
    mesh = sharding.make_mesh(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device={name} ranks={mesh.size} bank={args.bank}")

    bstate, params, rng = fleet_setup(args.bank, args.rate, args.seed, device, dtype)
    bstate = sharding.shard_bank(bstate, mesh)
    nb = bstate.cov.shape[0]
    true_v = torch.tensor(TRUE_VELOCITY, dtype=dtype, device=device)
    meas_cov = torch.eye(3, dtype=dtype, device=device) * DVL_VAR
    dt = 1.0 / args.rate
    n_ticks = int(args.rate)  # ticks actually run per simulated second
    dvl_every = max(1, round(args.rate / 5))  # ~5 Hz; every tick at low rates
    z = true_v.expand(nb, 3).contiguous()
    second = lambda bs, truth: second_of_steps(bs, params, z, truth, dt=dt, n_ticks=n_ticks, dvl_every=dvl_every,
                                               meas_cov=meas_cov)

    t_sim = 1.0  # simulated seconds elapsed (the truth moves at true_v from t=0)
    t0 = time.perf_counter()
    bstate, stats = second(bstate, true_v * t_sim)
    _sync(device)
    first_s = time.perf_counter() - t0
    print(f"first second (kernel build or load included): {first_s:.1f}s")

    t0 = time.perf_counter()
    n_sec = int(args.seconds)
    per_second = []
    for s in range(n_sec):
        t_sim += 1.0
        bstate, stats = second(bstate, true_v * t_sim)
        mean_pos, spread, mean_nees = stats
        if s % max(1, n_sec // 5) == 0:
            per_second.append((s + 1, mean_pos.tolist(), float(spread), float(mean_nees)))
            print(f"t={s + 1:3d}s  ensemble mean pos={np.round(mean_pos.tolist(), 3)}  "
                  f"spread={float(spread):.3f} m  position NEES={float(mean_nees):.2f}")
    _sync(device)
    wall = time.perf_counter() - t0
    steps = args.bank * n_ticks * n_sec
    rate = steps / wall if wall > 0 else float("inf")
    print(f"throughput: {rate:.6e} filter-steps/s over {mesh.size} device(s)")

    # consistency: velocity converged for every instance in the bank
    worst = float((bstate.mu.velocity - true_v).abs().max())
    print(f"worst-instance velocity error: {worst:.4f} m/s")
    if not worst < 0.05:
        raise AssertionError(f"bank diverged: worst velocity error {worst} m/s")

    # elastic recovery: poison 1% and let the self-healing step restart them
    # from the last healthy snapshot (here the bank itself; a checkpoint
    # restore in a long job)
    snapshot = bstate
    poisoned, dead_idx = poison(bstate, rng)
    heal = failover.self_healing_step(bank_step(params, dt, meas_cov))
    healed, info, _ = heal(poisoned, snapshot, z)
    n_reseeded = int(info.n_reseeded)
    healthy_after = bool(failover.health_mask(healed).all())
    print(f"failover: {n_reseeded}/{args.bank} poisoned instances restarted from snapshot")
    if n_reseeded != len(dead_idx):
        raise AssertionError(f"{n_reseeded} instances restarted, {len(dead_idx)} poisoned")
    if not healthy_after:
        raise AssertionError("heal left dead instances")
    print("FLEET OK")
    return {
        "device": name, "ranks": mesh.size, "bank": args.bank, "dtype": str(dtype).split(".")[-1],
        "first_second_s": first_s, "seconds": n_sec, "wall_s": wall, "filter_steps_per_s": rate,
        "per_second": per_second, "spread_m": float(stats[1]), "position_nees": float(stats[2]),
        "worst_velocity_error": worst, "n_poisoned": len(dead_idx),
        "n_reseeded": n_reseeded, "healthy_after_heal": healthy_after,
    }


if __name__ == "__main__":
    main()

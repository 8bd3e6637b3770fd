"""Monte-Carlo fleet mission replay — the fleet-scale accuracy harness, the
counterpart of ``slam_uwv_kalman_filters_tpu/models/monte_carlo.py``.

A survey mission runs as a bank with

- per-instance initial-state perturbations (:func:`perturb_initial_bank`),
- per-instance, per-tick sensor noise drawn on the bank's device each tick
  (so a (T, B, …) measurement tensor never exists),
- optionally banked Monte-Carlo parameters (K2's full mode on the lanes
  path), and
- streaming error accumulation: (B,) sums of squared position error, gated
  fixes accepted and DVL NIS instead of a (T, B, 3) trajectory.

Random numbers come from an explicit ``torch.Generator`` on the bank's
device, drawn in a fixed order each tick (gyro, acceleration, DVL, pressure,
then GPS). JAX derives each tick's key with ``fold_in(key, tick)``, so the
two packages draw different realizations from the same seed; with every
noise sigma zero they replay the same mission exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import manifolds as mf
from . import pose_driver as drv
from . import pose_fused as pf

__all__ = [
    "FleetMissionSpec",
    "FleetMissionResult",
    "perturb_initial_bank",
    "run_fleet_mission",
]


class FleetMissionSpec(NamedTuple):
    """Clean truth streams and noise model of one mission schedule. Streams
    carry a leading (T,) time axis; noise sigmas are scalars (i.i.d. per
    axis); the covariances are the measurement covariances the filter is
    given."""

    dt: float
    gyro: torch.Tensor  # (T, 3) clean gyro signal (true biases and earth rate included)
    acc: torch.Tensor  # (T, 3) clean specific force
    dvl: torch.Tensor  # (T, 3) clean body velocity
    pressure: torch.Tensor  # (T, 1) clean hydrostatic pressure
    truth_pos: torch.Tensor  # (T, 3) ground-truth position (the ATE reference)
    dvl_valid: torch.Tensor  # (T,) bool
    pressure_valid: torch.Tensor  # (T,) bool
    gyro_sigma: float
    acc_sigma: float
    dvl_sigma: float
    pressure_sigma: float
    acc_cov: torch.Tensor  # (3, 3)
    dvl_cov: torch.Tensor  # (3, 3)
    pressure_cov: torch.Tensor  # (1, 1)
    # χ²-95-gated surface fixes through the geographic-position update;
    # lat/lon and their sigmas in radians
    gps: Optional[torch.Tensor] = None  # (T, 2) clean (lat, lon)
    gps_valid: Optional[torch.Tensor] = None  # (T,) bool
    gps_lat_sigma: float = 0.0
    gps_lon_sigma: float = 0.0
    gps_cov: Optional[torch.Tensor] = None  # (2, 2)


class FleetMissionResult(NamedTuple):
    ate: torch.Tensor  # (B,) per-instance ATE RMSE [m]
    gps_accept_frac: torch.Tensor  # (B,) accepted / offered gated fixes (0 if none)
    dvl_nis_mean: torch.Tensor  # (B,) mean DVL NIS over valid ticks
    final_state: object  # bank-first final PoseUKFState


def perturb_initial_bank(bstate, generator: torch.Generator, *, pos_sigma: float = 0.2,
                         vel_sigma: float = 0.05, yaw_sigma: float = 3e-3):
    """Each instance starts from the same truth with its own plausibly wrong
    position, velocity and yaw estimate, drawn from ``generator`` (on the
    bank's device) in that order."""
    nb, dtype, dev = bstate.cov.shape[0], bstate.cov.dtype, bstate.cov.device
    randn = lambda *shape: torch.randn(*shape, generator=generator, dtype=dtype, device=dev)
    mu = bstate.mu
    pos = mu.position + pos_sigma * randn(nb, 3)
    vel = mu.velocity + vel_sigma * randn(nb, 3)
    dyaw = yaw_sigma * randn(nb)
    rotvec = torch.stack([torch.zeros_like(dyaw), torch.zeros_like(dyaw), dyaw], dim=-1)
    quat = mf.so3_boxplus(mu.orientation, rotvec)
    return bstate._replace(mu=mu._replace(position=pos, velocity=vel, orientation=quat))


def run_fleet_mission(bstate, params, spec: FleetMissionSpec, generator: torch.Generator,
                      consts: Optional[drv.PoseStepConstants] = None, *, path: str = "lanes"
                      ) -> FleetMissionResult:
    """Replay the mission over the bank and return per-instance accuracy and
    consistency statistics. ``params`` is shared or fully banked (then the
    lanes path predicts in K2's full mode with operands built once).
    ``path``: ``"lanes"`` (the bank in kernel layout for the whole replay,
    :func:`pose_driver.pose_step_bank_lanes`) or ``"bank"``
    (:func:`pose_driver.pose_step_bank`). The schedule's validity flags are
    shared by the bank, so a stream is left out of the ticks where it is
    invalid (a masked update with an all-false mask is the identity; JAX
    runs it masked). No tick waits for the device."""
    if path not in ("lanes", "bank"):
        raise ValueError(f"path must be 'lanes' or 'bank', got {path!r}")
    nb, dtype, dev = bstate.cov.shape[0], bstate.cov.dtype, bstate.cov.device
    n_ticks = spec.gyro.shape[0]
    dt = float(spec.dt)
    use_lanes = path == "lanes"
    ls = pf.to_lanes(bstate) if use_lanes else bstate
    banked_ops = None
    if use_lanes and params.process_noise.ndim == 3:
        banked_ops = pf.banked_predict_operands(params, dt, dtype)

    cast = lambda a: a.to(dtype=dtype, device=dev)
    flags = lambda a: a.to(device=dev)
    gyro, acc, dvl, pressure, truth = map(cast, (spec.gyro, spec.acc, spec.dvl, spec.pressure, spec.truth_pos))
    dvl_valid, pressure_valid = flags(spec.dvl_valid), flags(spec.pressure_valid)
    bank_cov = lambda c: cast(c).expand(nb, *c.shape)
    acc_cov, dvl_cov, pressure_cov = bank_cov(spec.acc_cov), bank_cov(spec.dvl_cov), bank_cov(spec.pressure_cov)
    has_gps = spec.gps is not None
    if has_gps:
        gps, gps_valid, gps_cov = cast(spec.gps), flags(spec.gps_valid), bank_cov(spec.gps_cov)
        gps_sigma = torch.tensor([float(spec.gps_lat_sigma), float(spec.gps_lon_sigma)], dtype=dtype, device=dev)
    dvl_on, pressure_on = spec.dvl_valid.tolist(), spec.pressure_valid.tolist()
    gps_on = spec.gps_valid.tolist() if has_gps else [False] * n_ticks
    randn = lambda *shape: torch.randn(*shape, generator=generator, dtype=dtype, device=dev)
    noisy = lambda v, s: v.expand(nb, *v.shape) + float(s) * randn(nb, *v.shape)
    dt_b = torch.full((nb,), dt, dtype=dtype, device=dev)
    ones_b = torch.ones(nb, dtype=torch.bool, device=dev)
    err = torch.zeros(nb, dtype=dtype, device=dev)
    g_acc, nis_sum = torch.zeros_like(err), torch.zeros_like(err)

    on = lambda flag, *streams: streams if flag else (None,) * len(streams)
    for k in range(n_ticks):
        # every tick draws every stream's noise, in a fixed order
        rotation_rate = noisy(gyro[k], spec.gyro_sigma)
        acc_k = noisy(acc[k], spec.acc_sigma)
        dvl_k = noisy(dvl[k], spec.dvl_sigma)
        pressure_k = noisy(pressure[k], spec.pressure_sigma)
        gps_in = (None, None, None)
        if has_gps:
            gps_k = gps[k].expand(nb, 2) + gps_sigma * randn(nb, 2)
            gps_in = on(gps_on[k], gps_k, gps_cov, gps_valid[k].expand(nb))
        dvl_in = on(dvl_on[k], dvl_k, dvl_cov, dvl_valid[k].expand(nb))
        pressure_in = on(pressure_on[k], pressure_k, pressure_cov, pressure_valid[k].expand(nb))
        inp = drv.PoseInputs(
            dt=dt_b, rotation_rate=rotation_rate,
            acc=acc_k, acc_cov=acc_cov, acc_valid=ones_b,
            dvl=dvl_in[0], dvl_cov=dvl_in[1], dvl_valid=dvl_in[2],
            pressure=pressure_in[0], pressure_cov=pressure_in[1], pressure_valid=pressure_in[2],
            # the schedule carries no XY, ADCP or efforts sensor
            xy=None, xy_cov=None, xy_valid=None,
            adcp=None, adcp_cov=None, adcp_cell_weighting=None, adcp_valid=None,
            efforts=None, efforts_cov=None, efforts_valid=None,
            gps=gps_in[0], gps_cov=gps_in[1], gps_valid=gps_in[2],
        )
        if use_lanes:
            ls, out = drv.pose_step_bank_lanes(ls, params, inp, consts, banked_ops=banked_ops)
        else:
            ls, out = drv.pose_step_bank(ls, params, inp, consts)
        err = err + ((out.position - truth[k]) ** 2).sum(-1)
        if out.gps_accepted is not None:
            g_acc = g_acc + out.gps_accepted.to(dtype)
        nis_sum = nis_sum + out.dvl_nis

    n_gps = spec.gps_valid.to(dtype).sum().to(dev) if has_gps else torch.zeros((), dtype=dtype, device=dev)
    n_dvl = spec.dvl_valid.to(dtype).sum().clamp(min=1.0).to(dev)
    return FleetMissionResult(
        ate=torch.sqrt(err / n_ticks),
        gps_accept_frac=torch.where(n_gps > 0, g_acc / n_gps.clamp(min=1.0), 0.0),
        dvl_nis_mean=nis_sum / n_dvl,
        final_state=pf.from_lanes(ls, bstate) if use_lanes else ls,
    )

"""Unscented RTS smoother for PoseUKF trajectories — offline survey
post-processing; counterpart of
``slam_uwv_kalman_filters_tpu/models/pose_smoother.py``.

The reference library is a forward filter; a survey's post-processing wants
the smoothed estimate p(x_k | z_1:T), which pulls the drift between sparse
position fixes back. This module adds the manifold unscented
Rauch–Tung–Striebel smoother (``ops.ukf.smooth_step``) on top of the replay
driver:

* forward: :func:`models.pose_driver.pose_step` (one trajectory) or
  :func:`models.pose_driver.pose_step_bank` (a bank of trajectories, the
  fused kernels on the card), storing every filtered posterior (μₖ, Pₖ). A
  sensor stream that no trajectory offers at a tick is left out of that
  tick, as ``monte_carlo.run_fleet_mission`` leaves it out: a masked update
  with an all-false mask is the identity (JAX runs it masked);
* backward: a reverse loop over the stored posteriors that re-runs the
  tick-(k+1) transition — that tick's rotation rate and dt, the
  state-dependent Q of ``pose_ukf.assemble_process_noise`` — and blends with
  the already-smoothed next state. On the card each backward tick draws its
  sigma points with K1 and solves for the gain with K8 (one (B, 53, 53)
  system per tick). The last tick is its own smoothed estimate.

Memory: the outputs hold T × B × (54 + 53²) values twice (filtered and
smoothed), preallocated: 3000 ticks of a 256-trajectory float32 bank are
8.6 GB of filtered covariances and as much smoothed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import ukf
from ..parallel.bank import tree_map
from . import pose_driver as drv
from . import pose_ukf as pukf

__all__ = ["SmoothedTrajectory", "run_trajectory_smoothed", "smooth_backward"]


class SmoothedTrajectory(NamedTuple):
    """Per-tick filtered and smoothed estimates (leading time axis; a bank
    axis after it for a bank of trajectories)."""

    filtered_mu: pukf.PoseState
    filtered_cov: torch.Tensor  # (T, [B,] 53, 53)
    smoothed_mu: pukf.PoseState
    smoothed_cov: torch.Tensor  # (T, [B,] 53, 53)


# the fields of each optional sensor stream, keyed by its validity flag
_STREAMS = {
    "acc_valid": ("acc", "acc_cov"),
    "dvl_valid": ("dvl", "dvl_cov"),
    "pressure_valid": ("pressure", "pressure_cov"),
    "xy_valid": ("xy", "xy_cov"),
    "adcp_valid": ("adcp", "adcp_cov", "adcp_cell_weighting"),
    "efforts_valid": ("efforts", "efforts_cov"),
    "z_valid": ("z", "z_cov"),
    "gps_valid": ("gps", "gps_cov"),
    "delayed_valid": ("delayed_xy", "delayed_xy_cov", "delayed_position"),
}


def _offered(inputs: drv.PoseInputs) -> dict:
    """For each stream present, the host list of ticks on which any
    trajectory offers it (one read of its flags for the whole schedule)."""
    n = inputs.dt.shape[0]
    return {flag: getattr(inputs, flag).reshape(n, -1).any(-1).tolist()
            for flag in _STREAMS if getattr(inputs, flag) is not None}


def _check_shared_dt(inputs: drv.PoseInputs) -> None:
    """Raise ``ValueError`` where a bank's (T, B) dt differs across its
    trajectories at some tick: the bank forms predict every trajectory with
    trajectory 0's interval (``pose_step_bank`` takes ``inp.dt[0]``). One
    host read of the schedule."""
    dt = inputs.dt.reshape(inputs.dt.shape[0], -1)
    varies = (dt != dt[:, :1]).any(-1)
    if bool(varies.any()):
        tick = int(varies.nonzero()[0, 0])
        raise ValueError(
            f"a smoothed bank needs one dt per tick across its trajectories; at tick {tick} it spans "
            f"[{float(dt[tick].min())}, {float(dt[tick].max())}] — smooth such trajectories one at a time"
        )


def smooth_backward(filtered_mu: pukf.PoseState, filtered_cov: torch.Tensor, params: pukf.PoseUKFParams,
                    inputs: drv.PoseInputs):
    """Backward URTS pass over stored filtered posteriors, the post-update
    state of every tick on a leading (T,) axis — (T, …) for one
    trajectory, (T, B, …) for a bank, with ``inputs`` shaped as the forward
    pass consumed them. The k → k+1 transition re-uses tick k+1's rotation
    rate and dt. A bank's dt must be shared across its trajectories at every
    tick (``inputs.dt[k + 1][0]`` is taken, as ``pose_step_bank`` takes it);
    a dt that differs raises ``ValueError``. Returns (smoothed_mu,
    smoothed_cov) shaped like the inputs."""
    solo = filtered_cov.ndim == 3
    if not solo:
        _check_shared_dt(inputs)
    if solo:
        filtered_mu, filtered_cov = tree_map(lambda a: a[:, None], filtered_mu), filtered_cov[:, None]
    n_ticks = filtered_cov.shape[0]
    smoothed_mu = tree_map(torch.empty_like, filtered_mu)
    smoothed_cov = torch.empty_like(filtered_cov)
    take = lambda tree, k: tree_map(lambda a: a[k], tree)
    mu_s, cov_s = take(filtered_mu, -1), filtered_cov[-1]
    tree_map(lambda out, a: out[-1].copy_(a), smoothed_mu, mu_s)
    smoothed_cov[-1].copy_(cov_s)
    for k in range(n_ticks - 2, -1, -1):
        mu_f, cov_f = take(filtered_mu, k), filtered_cov[k]
        rr_next = inputs.rotation_rate[k + 1]
        dt_next = inputs.dt[k + 1] if solo else inputs.dt[k + 1][0]
        if solo:
            rr_next = rr_next[None]
        q = pukf.assemble_process_noise(mu_f, params, dt_next)
        mu_s, cov_s = ukf.smooth_step(
            pukf.POSE_MANIFOLD, mu_f, cov_f,
            lambda chi: pukf._process_model(chi, rr_next, params, dt_next), q, mu_s, cov_s,
        )
        tree_map(lambda out, a: out[k].copy_(a), smoothed_mu, mu_s)
        smoothed_cov[k].copy_(cov_s)
    if solo:
        return tree_map(lambda a: a[:, 0], smoothed_mu), smoothed_cov[:, 0]
    return smoothed_mu, smoothed_cov


def run_trajectory_smoothed(state: pukf.PoseUKFState, params: pukf.PoseUKFParams,
                            inputs: drv.PoseInputs) -> SmoothedTrajectory:
    """Forward filter + backward smooth over a packed (T,)-tick schedule: one
    trajectory (``state.cov`` (53, 53), ``pose_step``) or a bank (``state.cov``
    (B, 53, 53), inputs (T, B, …), ``pose_step_bank``). A bank whose dt
    differs across its trajectories at some tick raises ``ValueError``."""
    n_ticks = inputs.dt.shape[0]
    step = drv.pose_step_bank if state.cov.ndim == 3 else drv.pose_step
    if state.cov.ndim == 3:
        _check_shared_dt(inputs)
    offered = _offered(inputs)
    mus = tree_map(lambda a: a.new_empty((n_ticks, *a.shape)), state.mu)
    covs = state.cov.new_empty((n_ticks, *state.cov.shape))
    for k in range(n_ticks):
        absent = [f for flag, on in offered.items() if not on[k] for f in (flag, *_STREAMS[flag])]
        state, _ = step(state, params, drv._tick(inputs, k)._replace(**dict.fromkeys(absent)))
        tree_map(lambda out, a: out[k].copy_(a), mus, state.mu)
        covs[k].copy_(state.cov)
    smus, scovs = smooth_backward(mus, covs, params, inputs)
    return SmoothedTrajectory(filtered_mu=mus, filtered_cov=covs, smoothed_mu=smus, smoothed_cov=scovs)

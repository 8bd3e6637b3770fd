"""Unscented RTS smoother for PoseUKF trajectories — offline survey
post-processing; counterpart of
``slam_uwv_kalman_filters_tpu/models/pose_smoother.py``.

The reference library is a forward filter; a survey's post-processing wants
the smoothed estimate p(x_k | z_1:T), which pulls the drift between sparse
position fixes back. This module adds the manifold unscented
Rauch–Tung–Striebel smoother (``ops.ukf.smooth_step``) on top of the replay
driver:

* forward: :func:`models.pose_driver.pose_step` (one trajectory) or
  :func:`models.pose_driver.pose_step_bank` (a bank of trajectories that
  share one dt a tick, the fused kernels on the card), storing every
  filtered posterior (μₖ, Pₖ). A
  sensor stream that no trajectory offers at a tick is left out of that
  tick, as ``monte_carlo.run_fleet_mission`` leaves it out: a masked update
  with an all-false mask is the identity (JAX runs it masked);
* backward: a reverse loop over the stored posteriors that re-runs the
  tick-(k+1) transition — that tick's rotation rate and dt, the
  state-dependent Q of ``pose_ukf.assemble_process_noise`` — and blends with
  the already-smoothed next state. On the card each backward tick draws its
  sigma points with K1 and solves for the gain with K8 (one (B, 53, 53)
  system per tick). The last tick is its own smoothed estimate.

A bank whose dt differs across its trajectories runs both passes as
``torch.func.vmap`` of the one-trajectory forms over the bank axis, as JAX
vmaps its smoother; K1 and K8 reach the whole bank in one launch a tick
through their vmap rules (``ops/kernels.py``).

Memory: the outputs hold T × B × (54 + 53²) values twice (filtered and
smoothed), preallocated: 3000 ticks of a 256-trajectory float32 bank are
8.6 GB of filtered covariances and as much smoothed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import ukf
from ..ops.cuda_lib import is_vmapped
from ..parallel.bank import tree_map, vmap_tree
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


def _dt_shared(inputs: drv.PoseInputs) -> bool:
    """Whether a bank's (T, B) dt is one value per tick across its
    trajectories (one host read of the schedule)."""
    dt = inputs.dt.reshape(inputs.dt.shape[0], -1)
    return not bool((dt != dt[:, :1]).any())


class _Store:
    """The per-tick outputs of a pass: written into tensors allocated once,
    or, for values batched by ``torch.func.vmap`` (which cannot be written
    into an unbatched tensor), kept per tick and stacked at the end."""

    def __init__(self, mu, cov, n_ticks: int, batched: bool):
        self.batched = batched
        if batched:
            self.mus, self.covs = [None] * n_ticks, [None] * n_ticks
        else:
            self.mus = tree_map(lambda a: a.new_empty((n_ticks, *a.shape)), mu)
            self.covs = cov.new_empty((n_ticks, *cov.shape))

    def put(self, k: int, mu, cov) -> None:
        if self.batched:
            self.mus[k], self.covs[k] = mu, cov
        else:
            tree_map(lambda out, a: out[k].copy_(a), self.mus, mu)
            self.covs[k].copy_(cov)

    def result(self):
        if self.batched:
            return tree_map(lambda *a: torch.stack(a), *self.mus), torch.stack(self.covs)
        return self.mus, self.covs


def _backward(filtered_mu, filtered_cov, params, rotation_rate, dt, batched: bool):
    """The backward pass over (T, B, …) posteriors, each tick k re-running
    the transition into k+1 with ``rotation_rate[k + 1]`` (B, 3) and
    ``dt[k + 1]`` (one interval for the bank); ``batched`` where the values
    are batched by ``torch.func.vmap``."""
    n_ticks = filtered_cov.shape[0]
    take = lambda tree, k: tree_map(lambda a: a[k], tree)
    mu_s, cov_s = take(filtered_mu, -1), filtered_cov[-1]
    store = _Store(mu_s, cov_s, n_ticks, batched)
    store.put(n_ticks - 1, mu_s, cov_s)
    for k in range(n_ticks - 2, -1, -1):
        mu_f, cov_f = take(filtered_mu, k), filtered_cov[k]
        rr_next, dt_next = rotation_rate[k + 1], dt[k + 1]
        q = pukf.assemble_process_noise(mu_f, params, dt_next)
        mu_s, cov_s = ukf.smooth_step(
            pukf.POSE_MANIFOLD, mu_f, cov_f,
            lambda chi: pukf._process_model(chi, rr_next, params, dt_next), q, mu_s, cov_s,
        )
        store.put(k, mu_s, cov_s)
    return store.result()


def _smooth_backward_solo(filtered_mu, filtered_cov, params, inputs):
    """The backward pass of one trajectory, (T, …), as a bank of one."""
    lift = lambda tree: tree_map(lambda a: a[:, None], tree)
    mu, cov = _backward(lift(filtered_mu), filtered_cov[:, None], params, inputs.rotation_rate[:, None], inputs.dt,
                        is_vmapped(filtered_mu, filtered_cov, inputs))
    return tree_map(lambda a: a[:, 0], mu), cov[:, 0]


def smooth_backward(filtered_mu: pukf.PoseState, filtered_cov: torch.Tensor, params: pukf.PoseUKFParams,
                    inputs: drv.PoseInputs):
    """Backward URTS pass over stored filtered posteriors, the post-update
    state of every tick on a leading (T,) axis — (T, …) for one
    trajectory, (T, B, …) for a bank, with ``inputs`` shaped as the forward
    pass consumed them. The k → k+1 transition re-uses tick k+1's rotation
    rate and dt. A bank whose dt is shared across its trajectories at every
    tick runs one banked smooth step a tick; where it differs, the
    one-trajectory pass runs under ``torch.func.vmap`` over the bank axis,
    so each trajectory keeps its own dt (as JAX's vmapped smoother does).
    The one-trajectory pass itself runs under ``torch.func.vmap``. Returns
    (smoothed_mu, smoothed_cov) shaped like the inputs."""
    if filtered_cov.ndim == 3:
        return _smooth_backward_solo(filtered_mu, filtered_cov, params, inputs)
    if _dt_shared(inputs):  # one (B, 53, 53) smooth step a tick (K1 and K8 on the card)
        return _backward(filtered_mu, filtered_cov, params, inputs.rotation_rate, inputs.dt[:, 0], False)
    return vmap_tree(_smooth_backward_solo, (1, 1, None, 1), out_dims=1)(filtered_mu, filtered_cov, params, inputs)


def _forward(step, state, params, inputs):
    """The forward pass: every tick's filtered (μ, P). Outside
    ``torch.func.vmap`` a stream that no trajectory offers at a tick is left
    out of it (one host read of the flags); under vmap the flags are per
    trajectory, so every stream runs masked on every tick, as in JAX."""
    n_ticks = inputs.dt.shape[0]
    batched = is_vmapped(state, inputs)
    offered = {} if batched else _offered(inputs)
    store = _Store(state.mu, state.cov, n_ticks, batched)
    for k in range(n_ticks):
        absent = [f for flag, on in offered.items() if not on[k] for f in (flag, *_STREAMS[flag])]
        state, _ = step(state, params, drv._tick(inputs, k)._replace(**dict.fromkeys(absent)))
        store.put(k, state.mu, state.cov)
    return store.result()


def _run_solo(state, params, inputs):
    mus, covs = _forward(drv.pose_step, state, params, inputs)
    smus, scovs = _smooth_backward_solo(mus, covs, params, inputs)
    return SmoothedTrajectory(filtered_mu=mus, filtered_cov=covs, smoothed_mu=smus, smoothed_cov=scovs)


def run_trajectory_smoothed(state: pukf.PoseUKFState, params: pukf.PoseUKFParams,
                            inputs: drv.PoseInputs) -> SmoothedTrajectory:
    """Forward filter + backward smooth over a packed (T,)-tick schedule: one
    trajectory (``state.cov`` (53, 53), ``pose_step``; it runs under
    ``torch.func.vmap`` too) or a bank (``state.cov`` (B, 53, 53), inputs
    (T, B, …)). A bank whose dt is shared across its trajectories at every
    tick runs ``pose_step_bank`` forward (the fused kernels on the card) and
    one banked smooth step a tick backward (K1 and K8); where the dt
    differs, both passes run the one-trajectory forms under
    ``torch.func.vmap`` over the bank axis, so each trajectory keeps its own
    dt, as JAX's vmapped smoother does (K1 and K8 then launch once a tick
    for the whole bank through their vmap rules)."""
    if state.cov.ndim == 2:
        return _run_solo(state, params, inputs)
    if not _dt_shared(inputs):
        return vmap_tree(_run_solo, (0, None, 1), out_dims=1)(state, params, inputs)
    mus, covs = _forward(drv.pose_step_bank, state, params, inputs)
    smus, scovs = smooth_backward(mus, covs, params, inputs)
    return SmoothedTrajectory(filtered_mu=mus, filtered_cov=covs, smoothed_mu=smus, smoothed_cov=scovs)

"""Whole-trajectory replay driver for PoseUKF — the counterpart of
``slam_uwv_kalman_filters_tpu/models/pose_driver.py`` (the reference's
host-component pattern: on each IMU tick ``predictionStep``, on each sensor
arrival the matching ``integrateMeasurement``).

An irregular multi-rate sensor schedule is packed into a dense per-tick
:class:`PoseInputs` with validity flags; an absent measurement is a masked
select, never control flow. JAX's ``lax.scan`` over ticks is a Python loop
here. Three forms, as in JAX:

* :func:`pose_step` / :func:`run_trajectory` — one filter, generic path;
* :func:`pose_step_bank` / :func:`run_trajectory_bank` — a bank through the
  ``pose_ukf.*_bank`` functions (generic on a CPU bank, the fused kernels on
  a CUDA bank);
* :func:`pose_step_bank_lanes` / :func:`run_trajectory_bank_lanes` — the
  bank held in kernel layout for the whole replay (one ``to_lanes`` in, one
  ``from_lanes`` out), every scheduled model on the fused lanes route.

Parameter sets may be shared or banked (Monte-Carlo sweeps). A sensor group
that is ``None`` in the inputs is never run. Visual-marker detections run the
59-DOF augmented update last in each tick (``pose_ukf.update_visual_features``
solo and bank, K11 through ``pose_marker_fused.update_visual_features_lanes``
on lanes state) and need ``PoseStepConstants(marker=MarkerSetup(...))``.
The ``run_*`` replays read the schedule's marker flags once and leave the
marker stream out of a tick on which no filter has a detection: there the
masked update would keep every filter's prior, so the result is the same.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import ukf
from ..ops.cuda_lib import is_vmapped
from ..parallel.bank import select_where
from ..utils.device import resolve_device
from . import pose_fused as pf
from . import pose_marker_fused as pmf
from . import pose_ukf as pukf
from . import pose_update_fused as puf

__all__ = [
    "PoseInputs",
    "MarkerSetup",
    "PoseStepConstants",
    "TickOutput",
    "make_inputs",
    "pose_step",
    "run_trajectory",
    "pose_step_bank",
    "run_trajectory_bank",
    "pose_step_bank_lanes",
    "run_trajectory_bank_lanes",
    "gps_update_lanes",
    "delayed_xy_update_lanes",
]


class MarkerSetup(NamedTuple):
    """Mission constants of the visual-marker stream: the marker geometry,
    the marker pose's prior and the camera calibration, as in JAX."""

    feature_positions: torch.Tensor  # (K, 3)
    marker_position: torch.Tensor  # (3,)
    marker_orientation: torch.Tensor  # (4,)
    cov_marker_pose: torch.Tensor  # (6, 6)
    camera: object
    camera_in_imu_position: torch.Tensor  # (3,)
    camera_in_imu_orientation: torch.Tensor  # (4,)


class PoseStepConstants(NamedTuple):
    """Per-mission constants of a step: sensor mounting and marker setup."""

    gps_in_body: Optional[torch.Tensor] = None  # (3,) antenna lever arm
    marker: Optional[MarkerSetup] = None


class PoseInputs(NamedTuple):
    """One tick of the packed sensor schedule (a leading time axis for the
    ``run_*`` functions, a bank axis after it for the bank forms). A sensor
    group may be ``None`` when the mission has no such sensor."""

    dt: torch.Tensor  # () prediction interval
    rotation_rate: torch.Tensor  # (3,) gyro input
    acc: Optional[torch.Tensor]  # (3,)
    acc_cov: Optional[torch.Tensor]  # (3, 3)
    acc_valid: Optional[torch.Tensor]  # () bool
    dvl: Optional[torch.Tensor]  # (3,)
    dvl_cov: Optional[torch.Tensor]  # (3, 3)
    dvl_valid: Optional[torch.Tensor]  # () bool
    pressure: Optional[torch.Tensor]  # (1,)
    pressure_cov: Optional[torch.Tensor]  # (1, 1)
    pressure_valid: Optional[torch.Tensor]  # () bool
    xy: Optional[torch.Tensor]  # (2,)
    xy_cov: Optional[torch.Tensor]  # (2, 2)
    xy_valid: Optional[torch.Tensor]  # () bool
    adcp: Optional[torch.Tensor]  # (2,)
    adcp_cov: Optional[torch.Tensor]  # (2, 2)
    adcp_cell_weighting: Optional[torch.Tensor]  # ()
    adcp_valid: Optional[torch.Tensor]  # () bool
    efforts: Optional[torch.Tensor]  # (6,)
    efforts_cov: Optional[torch.Tensor]  # (6, 6)
    efforts_valid: Optional[torch.Tensor]  # () bool
    z: Optional[torch.Tensor] = None  # (1,) depth
    z_cov: Optional[torch.Tensor] = None
    z_valid: Optional[torch.Tensor] = None
    gps: Optional[torch.Tensor] = None  # (2,) lat, lon [rad]
    gps_cov: Optional[torch.Tensor] = None
    gps_valid: Optional[torch.Tensor] = None
    delayed_xy: Optional[torch.Tensor] = None  # (2,)
    delayed_xy_cov: Optional[torch.Tensor] = None
    delayed_position: Optional[torch.Tensor] = None  # (2,) position at capture time
    delayed_valid: Optional[torch.Tensor] = None
    marker_features: Optional[torch.Tensor] = None  # (K, 2) pixels
    marker_feature_covs: Optional[torch.Tensor] = None  # (K, 2, 2)
    marker_valid: Optional[torch.Tensor] = None


class TickOutput(NamedTuple):
    position: torch.Tensor
    orientation: torch.Tensor
    velocity: torch.Tensor
    cov_trace: torch.Tensor
    dvl_nis: torch.Tensor  # DVL NIS, 0 on ticks without DVL
    adcp_accepted: torch.Tensor  # ADCP gate outcome, False on ticks without ADCP
    gps_accepted: Optional[torch.Tensor] = None
    marker_nis: Optional[torch.Tensor] = None


def make_inputs(
    n: int,
    dt: float,
    rotation_rate,
    *,
    acc=None, acc_cov=None, acc_valid=None,
    dvl=None, dvl_cov=None, dvl_valid=None,
    pressure=None, pressure_cov=None, pressure_valid=None,
    xy=None, xy_cov=None, xy_valid=None,
    adcp=None, adcp_cov=None, adcp_cell_weighting=None, adcp_valid=None,
    efforts=None, efforts_cov=None, efforts_valid=None,
    z=None, z_cov=None, z_valid=None,
    gps=None, gps_cov=None, gps_valid=None,
    delayed_xy=None, delayed_xy_cov=None, delayed_position=None, delayed_valid=None,
    marker_features=None, marker_feature_covs=None, marker_valid=None,
    dtype=torch.float64,
    device=None,
) -> PoseInputs:
    """A dense (n,)-tick schedule, as JAX ``make_inputs``: omitted always-on
    streams get all-invalid dummy slots, omitted event-rate streams
    (``z``/``gps``/``delayed_*``/``marker_*``) stay ``None``. A stream is
    per tick, (n, …), or one constant value."""
    device = resolve_device(device)
    t = lambda x, dt_=dtype: torch.as_tensor(x, dtype=dt_, device=device)
    if marker_features is not None:
        marker_features = t(marker_features)
        if marker_features.ndim not in (2, 3):
            raise ValueError(
                f"marker_features has shape {tuple(marker_features.shape)}; expected "
                "(K,2) (constant detections) or (n,K,2) (per tick)"
            )

    def fill(x, shape, default=0.0):
        if x is None:
            return torch.full((n, *shape), default, dtype=dtype, device=device)
        x = t(x)
        if x.ndim == len(shape):
            return x.expand(n, *shape)
        if tuple(x.shape) != (n, *shape):
            raise ValueError(
                f"sensor stream has shape {tuple(x.shape)}; expected {(n, *shape)} "
                f"(per tick) or {tuple(shape)} (constant)"
            )
        return x

    def fill_cov(x, d):
        if x is None:
            return torch.eye(d, dtype=dtype, device=device).expand(n, d, d)
        x = t(x)
        return x.expand(n, d, d) if x.ndim == 2 else x

    def flag(v, provided):
        if v is None:
            return torch.full((n,), bool(provided), device=device)
        v = t(v, torch.bool)
        return v.expand(n) if v.ndim == 0 else v

    def required(x, name):
        if x is None:
            raise ValueError(f"{name} is required when its sensor stream is provided")
        return x

    def corner_covs(x, k):
        x = t(x)
        if tuple(x.shape) == (k, 2, 2):
            return x.expand(n, k, 2, 2)
        if tuple(x.shape) != (n, k, 2, 2):
            raise ValueError(
                f"marker_feature_covs has shape {tuple(x.shape)}; expected {(k, 2, 2)} or {(n, k, 2, 2)}"
            )
        return x

    return PoseInputs(
        dt=torch.full((n,), float(dt), dtype=dtype, device=device),
        rotation_rate=fill(rotation_rate, (3,)),
        acc=fill(acc, (3,)), acc_cov=fill_cov(acc_cov, 3), acc_valid=flag(acc_valid, acc is not None),
        dvl=fill(dvl, (3,)), dvl_cov=fill_cov(dvl_cov, 3), dvl_valid=flag(dvl_valid, dvl is not None),
        pressure=fill(pressure, (1,)), pressure_cov=fill_cov(pressure_cov, 1),
        pressure_valid=flag(pressure_valid, pressure is not None),
        xy=fill(xy, (2,)), xy_cov=fill_cov(xy_cov, 2), xy_valid=flag(xy_valid, xy is not None),
        adcp=fill(adcp, (2,)), adcp_cov=fill_cov(adcp_cov, 2),
        adcp_cell_weighting=fill(adcp_cell_weighting, ()), adcp_valid=flag(adcp_valid, adcp is not None),
        efforts=fill(efforts, (6,)), efforts_cov=fill_cov(efforts_cov, 6),
        efforts_valid=flag(efforts_valid, efforts is not None),
        z=None if z is None else fill(z, (1,)),
        z_cov=None if z is None else fill_cov(z_cov, 1),
        z_valid=None if z is None else flag(z_valid, True),
        gps=None if gps is None else fill(gps, (2,)),
        gps_cov=None if gps is None else fill_cov(gps_cov, 2),
        gps_valid=None if gps is None else flag(gps_valid, True),
        delayed_xy=None if delayed_xy is None else fill(delayed_xy, (2,)),
        delayed_xy_cov=None if delayed_xy is None else fill_cov(delayed_xy_cov, 2),
        delayed_position=(
            None if delayed_xy is None else fill(required(delayed_position, "delayed_position"), (2,))
        ),
        delayed_valid=None if delayed_xy is None else flag(delayed_valid, True),
        marker_features=(
            None if marker_features is None
            else fill(marker_features, tuple(marker_features.shape[-2:]))
        ),
        marker_feature_covs=(
            None if marker_features is None
            else corner_covs(required(marker_feature_covs, "marker_feature_covs"), marker_features.shape[-2])
        ),
        marker_valid=None if marker_features is None else flag(marker_valid, True),
    )


def _marker_args(inp: PoseInputs, consts: Optional[PoseStepConstants]) -> tuple:
    """The marker update's arguments after the state and parameters."""
    if consts is None or consts.marker is None:
        raise ValueError("schedule carries marker detections; pass PoseStepConstants(marker=MarkerSetup(...))")
    ms = consts.marker
    return (inp.marker_features, inp.marker_feature_covs, ms.feature_positions, ms.marker_position,
            ms.marker_orientation, ms.cov_marker_pose, ms.camera, ms.camera_in_imu_position,
            ms.camera_in_imu_orientation)


def _masked_update(state, valid, update_fn, *args):
    """Apply an update only where ``valid`` (a () or (B,) mask); returns
    (state, info) so gated sensors stay observable."""
    new_state, info = update_fn(*args)
    return select_where(valid, new_state, state), info


def _outputs(position, orientation, velocity, cov_trace, inp, dvl_info, adcp_info, gps_accepted, marker_nis=None):
    zero = torch.zeros_like(inp.dt)
    return TickOutput(
        position=position,
        orientation=orientation,
        velocity=velocity,
        cov_trace=cov_trace,
        dvl_nis=(
            torch.where(inp.dvl_valid, dvl_info.mahalanobis2, zero) if dvl_info is not None else zero
        ),
        adcp_accepted=(
            inp.adcp_valid & adcp_info.accepted if adcp_info is not None else zero.to(torch.bool)
        ),
        gps_accepted=gps_accepted,
        marker_nis=marker_nis,
    )


def pose_step(state, params, inp: PoseInputs, consts: Optional[PoseStepConstants] = None):
    """One tick of one filter: cache the gyro input → predict → masked
    sensor updates, in the reference's integration order."""
    state = pukf.integrate_rotation_rate(state, inp.rotation_rate)
    state = pukf.predict(state, params, inp.dt)
    if inp.acc is not None:
        state, _ = _masked_update(state, inp.acc_valid, pukf.update_acceleration,
                                  state, params, inp.acc, inp.acc_cov)
    dvl_info = None
    if inp.dvl is not None:
        state, dvl_info = _masked_update(state, inp.dvl_valid, pukf.update_velocity,
                                         state, params, inp.dvl, inp.dvl_cov)
    if inp.pressure is not None:
        state, _ = _masked_update(state, inp.pressure_valid, pukf.update_pressure,
                                  state, params, inp.pressure, inp.pressure_cov)
    if inp.xy is not None:
        state, _ = _masked_update(state, inp.xy_valid, pukf.update_xy_position,
                                  state, params, inp.xy, inp.xy_cov)
    adcp_info = None
    if inp.adcp is not None:
        state, adcp_info = _masked_update(state, inp.adcp_valid, pukf.update_water_velocity,
                                          state, params, inp.adcp, inp.adcp_cov, inp.adcp_cell_weighting)
    if inp.efforts is not None:
        state, _ = _masked_update(state, inp.efforts_valid, pukf.update_body_efforts,
                                  state, params, inp.efforts, inp.efforts_cov)
    if inp.z is not None:
        state, _ = _masked_update(state, inp.z_valid, pukf.update_z_position,
                                  state, params, inp.z, inp.z_cov)
    gps_accepted = None
    if inp.gps is not None:
        gps_in_body = consts.gps_in_body if consts is not None else None
        state, gps_info = _masked_update(state, inp.gps_valid, pukf.update_geographic_position,
                                         state, params, inp.gps[0], inp.gps[1], inp.gps_cov, gps_in_body)
        gps_accepted = inp.gps_valid & gps_info.accepted
    if inp.delayed_xy is not None:
        state, _ = _masked_update(state, inp.delayed_valid, pukf.update_delayed_position,
                                  state, params, inp.delayed_xy, inp.delayed_xy_cov, inp.delayed_position)
    marker_nis = None
    if inp.marker_features is not None:
        state, m_info = _masked_update(state, inp.marker_valid, pukf.update_visual_features,
                                       state, params, *_marker_args(inp, consts))
        marker_nis = torch.where(inp.marker_valid, m_info.mahalanobis2, 0.0)
    return state, _outputs(state.mu.position, state.mu.orientation, state.mu.velocity,
                           torch.trace(state.cov), inp, dvl_info, adcp_info, gps_accepted, marker_nis)


def _tick(inputs: PoseInputs, k: int) -> PoseInputs:
    return PoseInputs(*(None if x is None else x[k] for x in inputs))


def _stack(outs: list) -> TickOutput:
    return TickOutput(*(None if col[0] is None else torch.stack(col) for col in zip(*outs)))


def _replay(step, state, inputs: PoseInputs):
    """Run ``step(state, tick inputs)`` over the (T,)-tick schedule and stack
    the outputs. A tick on which no filter has a marker detection runs
    without the marker stream (its masked update would keep every prior)
    and records a marker NIS of 0: one host read of the marker flags per
    replay. Under ``torch.func.vmap`` the flags are per instance and cannot
    be read on the host, so every tick runs the marker update masked, as
    JAX does."""
    n = inputs.dt.shape[0]
    marker_on = None
    if inputs.marker_valid is not None and not is_vmapped(inputs.marker_valid):
        marker_on = inputs.marker_valid.reshape(n, -1).any(1).tolist()
    outs = []
    for k in range(n):
        inp = _tick(inputs, k)
        if marker_on is None or marker_on[k]:
            state, out = step(state, inp)
        else:
            state, out = step(state, inp._replace(marker_features=None, marker_feature_covs=None, marker_valid=None))
            out = out._replace(marker_nis=torch.zeros(inp.marker_features.shape[:-1], dtype=inp.dt.dtype,
                                                      device=inp.dt.device))
        outs.append(out)
    return state, _stack(outs)


def run_trajectory(state, params, inputs: PoseInputs, consts: Optional[PoseStepConstants] = None):
    """Replay a (T,)-tick schedule on one filter; outputs carry a leading
    (T,) axis."""
    return _replay(lambda s, inp: pose_step(s, params, inp, consts), state, inputs)


def pose_step_bank(bstate, params, inp: PoseInputs, consts: Optional[PoseStepConstants] = None):
    """Bank tick, the integration order of :func:`pose_step`; ``inp`` has a
    leading bank axis on every leaf and the prediction interval is shared
    (``inp.dt[0]``). Each phase is a ``pose_ukf.*_bank`` call: generic on a
    CPU bank, the fused kernels on a CUDA bank."""
    bstate = bstate._replace(rotation_rate=inp.rotation_rate)
    bstate = pukf.predict_bank(bstate, params, inp.dt[0])
    if inp.acc is not None:
        bstate, _ = _masked_update(bstate, inp.acc_valid, pukf.update_acceleration_bank,
                                   bstate, params, inp.acc, inp.acc_cov)
    dvl_info = None
    if inp.dvl is not None:
        bstate, dvl_info = _masked_update(bstate, inp.dvl_valid, pukf.update_velocity_bank,
                                          bstate, params, inp.dvl, inp.dvl_cov)
    if inp.pressure is not None:
        bstate, _ = _masked_update(bstate, inp.pressure_valid, pukf.update_pressure_bank,
                                   bstate, params, inp.pressure, inp.pressure_cov)
    if inp.xy is not None:
        bstate, _ = _masked_update(bstate, inp.xy_valid, pukf.update_xy_position_bank,
                                   bstate, params, inp.xy, inp.xy_cov)
    adcp_info = None
    if inp.adcp is not None:
        bstate, adcp_info = _masked_update(bstate, inp.adcp_valid, pukf.update_water_velocity_bank,
                                           bstate, params, inp.adcp, inp.adcp_cov, inp.adcp_cell_weighting)
    if inp.efforts is not None:
        # each instance's own compensated body rate; a banked vehicle model
        # broadcasts along the bank inside the measurement model
        rr_bank = pukf.get_rotation_rate_bank(bstate, params)
        bstate, _ = _masked_update(bstate, inp.efforts_valid, pukf.update_body_efforts_bank,
                                   bstate, params, inp.efforts, inp.efforts_cov, rr_bank)
    if inp.z is not None:
        bstate, _ = _masked_update(bstate, inp.z_valid, pukf.update_z_position_bank,
                                   bstate, params, inp.z, inp.z_cov)
    gps_accepted = None
    if inp.gps is not None:
        gps_in_body = consts.gps_in_body if consts is not None else None
        bstate, gps_info = _masked_update(
            bstate, inp.gps_valid, pukf.update_geographic_position_bank,
            bstate, params, inp.gps[:, 0], inp.gps[:, 1], inp.gps_cov, gps_in_body,
        )
        gps_accepted = inp.gps_valid & gps_info.accepted
    if inp.delayed_xy is not None:
        bstate, _ = _masked_update(bstate, inp.delayed_valid, pukf.update_delayed_position_bank,
                                   bstate, params, inp.delayed_xy, inp.delayed_xy_cov, inp.delayed_position)
    marker_nis = None
    if inp.marker_features is not None:
        bstate, m_info = _masked_update(bstate, inp.marker_valid, pukf.update_visual_features_bank,
                                        bstate, params, *_marker_args(inp, consts))
        marker_nis = torch.where(inp.marker_valid[:, None], m_info.mahalanobis2, 0.0)
    cov_trace = torch.diagonal(bstate.cov, dim1=-2, dim2=-1).sum(-1)
    return bstate, _outputs(bstate.mu.position, bstate.mu.orientation, bstate.mu.velocity,
                            cov_trace, inp, dvl_info, adcp_info, gps_accepted, marker_nis)


def run_trajectory_bank(bstate, params, inputs: PoseInputs, consts: Optional[PoseStepConstants] = None):
    """Fleet replay of :func:`pose_step_bank` over (T, B, …) inputs."""
    return _replay(lambda s, inp: pose_step_bank(s, params, inp, consts), bstate, inputs)


# ---------------------------------------------------------------------------
# the replay in kernel layout
# ---------------------------------------------------------------------------


def _lanes_select(valid, new_ls, old_ls):
    """Masked accept on kernel-layout state: (B,) validity along the
    trailing bank axis."""
    return old_ls._replace(
        cov_t=torch.where(valid, new_ls.cov_t, old_ls.cov_t),
        mu_t=torch.where(valid, new_ls.mu_t, old_ls.mu_t),
    )


def gps_update_lanes(ls, params, lat, lon, gps_cov, gps_in_body=None):
    """GPS fix on kernel-layout state (``PoseUKF.cpp:567-579``): project each
    instance's (lat, lon), correct the lever arm with its own mean
    orientation, then the χ²-95-gated in-kernel XY update. Returns
    ``(LanesBankState, UpdateInfo)``; apply through the validity mask."""
    dtype, device, nb = ls.cov_t.dtype, ls.cov_t.device, ls.cov_t.shape[-1]
    lat = torch.as_tensor(lat, dtype=dtype, device=device).expand(nb)
    lon = torch.as_tensor(lon, dtype=dtype, device=device).expand(nb)
    projected = pukf._geographic_xy(params, lat, lon, ls.mu_t[3:7].T, gps_in_body, nb)
    return puf.update_model_lanes("xy_position", ls, projected, gps_cov, ukf.D2P95)


def delayed_xy_update_lanes(ls, delayed_xy, delayed_cov, delayed_position):
    """Active delayed-position fix on kernel-layout state
    (``PoseUKF.cpp:514-527``): shift by each instance's (current − delayed)
    position, then the in-kernel XY update."""
    dtype, device = ls.cov_t.dtype, ls.cov_t.device
    shifted = torch.as_tensor(delayed_xy, dtype=dtype, device=device) + (
        ls.mu_t[0:2].T - torch.as_tensor(delayed_position, dtype=dtype, device=device)
    )
    return puf.update_model_lanes("xy_position", ls, shifted, delayed_cov)


def pose_step_bank_lanes(lstate, params, inp: PoseInputs, consts: Optional[PoseStepConstants] = None,
                         *, banked_ops=None):
    """Bank tick on kernel-layout state (``pose_fused.LanesBankState``): the
    integration order of :func:`pose_step_bank`, the covariance never
    leaving the (col, row, B) layout. A banked ``params`` predicts in K2's
    full mode (pass :func:`pose_fused.banked_predict_operands` once per
    mission as ``banked_ops``), its ``atmospheric_pressure`` rides K3's
    per-instance aux lanes, and a banked vehicle model sends the efforts
    update through the generic-h route (K1, ``h``, K4). Marker detections
    run K11 (``pose_marker_fused.update_visual_features_lanes``)."""
    dtype = lstate.cov_t.dtype
    ls = pf.set_rotation_rate_lanes(lstate, inp.rotation_rate)
    ls = pf.predict_lanes(ls, params, inp.dt[0], banked_ops=banked_ops)
    if inp.acc is not None:
        new, _ = puf.update_model_lanes("acceleration", ls, inp.acc, inp.acc_cov)
        ls = _lanes_select(inp.acc_valid, new, ls)
    dvl_info = None
    if inp.dvl is not None:
        new, dvl_info = puf.update_velocity_lanes(ls, params, inp.dvl, inp.dvl_cov)
        ls = _lanes_select(inp.dvl_valid, new, ls)
    if inp.pressure is not None:
        p_atm = params.atmospheric_pressure
        if p_atm.ndim >= 1:
            new, _ = puf.update_model_lanes(
                "pressure", ls, inp.pressure, inp.pressure_cov, aux_bank=p_atm.to(dtype)[:, None]
            )
        else:
            new, _ = puf.update_model_lanes(
                "pressure", ls, inp.pressure, inp.pressure_cov, aux=(p_atm, 0.0, 0.0, 0.0)
            )
        ls = _lanes_select(inp.pressure_valid, new, ls)
    if inp.xy is not None:
        new, _ = puf.update_model_lanes("xy_position", ls, inp.xy, inp.xy_cov)
        ls = _lanes_select(inp.xy_valid, new, ls)
    adcp_info = None
    if inp.adcp is not None:
        new, adcp_info = puf.update_model_lanes(
            "water_velocity", ls, inp.adcp, inp.adcp_cov, ukf.D2P95,
            aux_bank=inp.adcp_cell_weighting[:, None],
        )
        ls = _lanes_select(inp.adcp_valid, new, ls)
    if inp.efforts is not None:
        new, _ = puf.update_body_efforts_lanes(ls, params, inp.efforts, inp.efforts_cov)
        ls = _lanes_select(inp.efforts_valid, new, ls)
    if inp.z is not None:
        new, _ = puf.update_model_lanes("z_position", ls, inp.z, inp.z_cov)
        ls = _lanes_select(inp.z_valid, new, ls)
    gps_accepted = None
    if inp.gps is not None:
        gps_in_body = consts.gps_in_body if consts is not None else None
        new, gps_info = gps_update_lanes(ls, params, inp.gps[:, 0], inp.gps[:, 1], inp.gps_cov, gps_in_body)
        ls = _lanes_select(inp.gps_valid, new, ls)
        gps_accepted = inp.gps_valid & gps_info.accepted
    if inp.delayed_xy is not None:
        new, _ = delayed_xy_update_lanes(ls, inp.delayed_xy, inp.delayed_xy_cov, inp.delayed_position)
        ls = _lanes_select(inp.delayed_valid, new, ls)
    marker_nis = None
    if inp.marker_features is not None:
        new, m_info = pmf.update_visual_features_lanes(ls, *_marker_args(inp, consts))
        ls = _lanes_select(inp.marker_valid, new, ls)
        marker_nis = torch.where(inp.marker_valid[:, None], m_info.mahalanobis2, 0.0)
    # the diagonal belongs to the valid half
    cov_trace = torch.diagonal(ls.cov_t, dim1=0, dim2=1).sum(-1)
    mu = ls.mu_t
    return ls, _outputs(mu[0:3].T, mu[3:7].T, mu[7:10].T, cov_trace, inp, dvl_info, adcp_info, gps_accepted,
                        marker_nis)


def run_trajectory_bank_lanes(bstate, params, inputs: PoseInputs, consts: Optional[PoseStepConstants] = None):
    """Fleet replay with the bank in kernel layout for the whole schedule:
    one ``to_lanes`` in, one ``from_lanes`` out, the fused kernels every
    tick. Same semantics as :func:`run_trajectory_bank`. A banked ``params``
    builds the full-mode predict operands once, which bakes tick 0's
    interval into them: the schedule's dt must then be constant (as
    :func:`make_inputs` makes it), and a varying one raises."""
    ls = pf.to_lanes(bstate)
    banked_ops = None
    if params.process_noise.ndim == 3:
        dt = inputs.dt.reshape(-1)
        if dt.numel() and not bool((dt == dt[0]).all()):
            raise ValueError(
                "run_trajectory_bank_lanes with banked parameters requires a constant "
                "prediction interval (the banked predict operands bake dt once); this "
                f"schedule's dt varies over [{float(dt.min())}, {float(dt.max())}] — use "
                "run_trajectory_bank for variable-dt banked replays"
            )
        banked_ops = pf.banked_predict_operands(params, float(dt[0]), bstate.cov.dtype)
    ls, outs = _replay(lambda s, inp: pose_step_bank_lanes(s, params, inp, consts, banked_ops=banked_ops), ls,
                       inputs)
    return pf.from_lanes(ls, bstate), outs

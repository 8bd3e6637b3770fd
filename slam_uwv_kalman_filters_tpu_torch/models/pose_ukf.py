"""PoseUKF — model-aided inertial localization, the counterpart of
``slam_uwv_kalman_filters_tpu/models/pose_ukf.py`` (reference ``PoseUKF``,
Arnold & Medagoda, ICRA 2018): a 53-DOF UKF over position, orientation,
velocity, acceleration, IMU biases, gravity, the (x, y, ψ) inertia and
damping sub-model, water currents, ADCP bias and water density.

This port holds the constructors, the process model and process-noise
assembly, prediction, the measurement updates (velocity, acceleration, z
and xy position, geographic position, delayed position, pressure, water
velocity, body efforts in full mode and velocity-only, visual markers
through the 59-DOF augmentation), the delayed-state surface (out-of-sequence
fixes through the delayed-state buffer, the 55-DOF augmented delayed fix,
the external-pose reset), each in solo and ``_bank`` form, and the
reference's ``PoseUKF`` class over the solo functions.

* Solo functions take one filter (leaves without a bank axis) and run the
  generic path (``ops/ukf.py``) on a bank of one.
* ``*_bank`` functions take a bank (leading axis on every state leaf) and a
  parameter set that is either shared or banked (a leading bank axis on
  every leaf — a Monte-Carlo sweep). JAX ``vmap``s over a banked set; here
  each banked leaf broadcasts along the bank axis (:func:`_per_field` lifts
  the scalar ones). A CUDA bank goes through the fused kernels
  (``models/pose_fused.py``, ``models/pose_update_fused.py``); a CPU bank
  takes the generic path; any other device raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import dynamics as dyn
from ..ops import geodesy as geo
from ..ops import manifolds as mf
from ..ops import ukf
from ..parallel.bank import select_where, tree_map
from ..utils import delayed_states
from ..utils.config import CameraConfiguration, PoseUKFConfig
from ..utils.device import resolve_device
from ..utils.memo import per_device
from ..utils.validation import check_measurement
from .indirect_pose_ukf import _as, _check_corners, pixel_cov_to_s2, pixel_to_s2

__all__ = [
    "PoseState",
    "POSE_MANIFOLD",
    "PoseStateWithMarker",
    "POSE_MARKER_MANIFOLD",
    "PoseUKFParams",
    "PoseUKFState",
    "initial_state_from_config",
    "initial_cov_from_config",
    "params_from_config",
    "process_noise_from_config",
    "init_from_pose",
    "init_from_state",
    "assemble_process_noise",
    "predict",
    "predict_bank",
    "update_bank",
    "get_rotation_rate",
    "get_rotation_rate_bank",
    "integrate_rotation_rate",
    "update_velocity",
    "update_acceleration",
    "update_z_position",
    "update_xy_position",
    "update_pressure",
    "update_water_velocity",
    "update_body_efforts",
    "update_geographic_position",
    "update_delayed_position",
    "update_velocity_bank",
    "update_acceleration_bank",
    "update_z_position_bank",
    "update_xy_position_bank",
    "update_pressure_bank",
    "update_water_velocity_bank",
    "update_body_efforts_bank",
    "update_geographic_position_bank",
    "update_delayed_position_bank",
    "update_visual_features",
    "update_visual_features_bank",
    "PoseStateWithDelayedPosition",
    "POSE_DELAYED_MANIFOLD",
    "update_delayed_position_with_augmentation",
    "update_delayed_position_with_augmentation_bank",
    "push_delayed_state",
    "push_delayed_state_bank",
    "update_delayed_position_buffered",
    "update_delayed_position_buffered_bank",
    "reset_with_external_pose",
    "PoseUKF",
]


class PoseState(NamedTuple):
    """Field-for-field mirror of ``MTK_BUILD_MANIFOLD(PoseState, ...)``."""

    position: torch.Tensor  # (3,) IMU position in navigation (NWU) frame
    orientation: torch.Tensor  # (4,) quaternion [w,x,y,z], IMU in nav frame
    velocity: torch.Tensor  # (3,) IMU velocity in nav frame
    acceleration: torch.Tensor  # (3,) IMU acceleration in nav frame
    bias_gyro: torch.Tensor  # (3,)
    bias_acc: torch.Tensor  # (3,)
    gravity: torch.Tensor  # (1,) local gravity refinement
    inertia: torch.Tensor  # (3,3) (x,y,ψ) inertia sub-model, 9 DOF col-major
    lin_damping: torch.Tensor  # (3,3)
    quad_damping: torch.Tensor  # (3,3)
    water_velocity: torch.Tensor  # (2,) N/W current at the vehicle
    water_velocity_below: torch.Tensor  # (2,) N/W current below the vehicle
    bias_adcp: torch.Tensor  # (2,)
    water_density: torch.Tensor  # (1,) [kg/m³]


POSE_MANIFOLD = mf.make_manifold(
    mf.Field("position", "vec", 3),
    mf.Field("orientation", "so3"),
    mf.Field("velocity", "vec", 3),
    mf.Field("acceleration", "vec", 3),
    mf.Field("bias_gyro", "vec", 3),
    mf.Field("bias_acc", "vec", 3),
    mf.Field("gravity", "vec", 1),
    mf.Field("inertia", "mat33"),
    mf.Field("lin_damping", "mat33"),
    mf.Field("quad_damping", "mat33"),
    mf.Field("water_velocity", "vec", 2),
    mf.Field("water_velocity_below", "vec", 2),
    mf.Field("bias_adcp", "vec", 2),
    mf.Field("water_density", "vec", 1),
)  # DOF = 53 → 107 sigma points
if POSE_MANIFOLD.dof != 53:
    raise AssertionError("PoseState must have 53 tangent DOF")


class PoseStateWithMarker(NamedTuple):
    """``MTK_BUILD_MANIFOLD(PoseStateWithMarker, ...)`` (``src/PoseUKF.cpp:225-228``),
    flattened: the 53 DOF of :class:`PoseState`, then the marker pose (59 DOF,
    119 sigma points). Storage rows 54:57 hold the marker position and 57:61
    its quaternion; tangent rows 53:56 and 56:59."""

    position: torch.Tensor
    orientation: torch.Tensor
    velocity: torch.Tensor
    acceleration: torch.Tensor
    bias_gyro: torch.Tensor
    bias_acc: torch.Tensor
    gravity: torch.Tensor
    inertia: torch.Tensor
    lin_damping: torch.Tensor
    quad_damping: torch.Tensor
    water_velocity: torch.Tensor
    water_velocity_below: torch.Tensor
    bias_adcp: torch.Tensor
    water_density: torch.Tensor
    marker_position: torch.Tensor  # (3,)
    marker_orientation: torch.Tensor  # (4,)


POSE_MARKER_MANIFOLD = mf.make_manifold(
    *POSE_MANIFOLD.fields,
    mf.Field("marker_position", "vec", 3),
    mf.Field("marker_orientation", "so3"),
)
if POSE_MARKER_MANIFOLD.dof != 59:
    raise AssertionError("PoseStateWithMarker must have 59 tangent DOF")


class PoseUKFParams(NamedTuple):
    """``PoseUKFParameter`` plus the Markov rest points, the vehicle model,
    the projection anchor and the assembled process noise."""

    imu_in_body: torch.Tensor  # (3,)
    gyro_bias_offset: torch.Tensor  # (3,)
    gyro_bias_tau: torch.Tensor  # ()
    acc_bias_offset: torch.Tensor  # (3,)
    acc_bias_tau: torch.Tensor  # ()
    inertia_tau: torch.Tensor  # ()
    lin_damping_tau: torch.Tensor  # ()
    quad_damping_tau: torch.Tensor  # ()
    water_velocity_tau: torch.Tensor  # ()
    water_velocity_limits: torch.Tensor  # ()
    water_velocity_scale: torch.Tensor  # ()
    adcp_bias_tau: torch.Tensor  # ()
    atmospheric_pressure: torch.Tensor  # ()
    water_density_tau: torch.Tensor  # ()
    inertia_offset: torch.Tensor  # (3,3) Markov rest point
    lin_damping_offset: torch.Tensor  # (3,3)
    quad_damping_offset: torch.Tensor  # (3,3)
    water_density_offset: torch.Tensor  # ()
    model: dyn.UWVParameters
    projection: geo.GeographicProjection
    process_noise: torch.Tensor  # (53,53)


class PoseUKFState(NamedTuple):
    mu: PoseState
    cov: torch.Tensor  # (53,53)
    rotation_rate: torch.Tensor  # (3,) cached IMU rates (process input)


# ---------------------------------------------------------------------------
# construction (PoseUKF ctors + setProcessNoiseFromConfig)
# ---------------------------------------------------------------------------


def _rot_or_eye(imu_in_body_rot, dtype, device):
    if imu_in_body_rot is None:
        return torch.eye(3, dtype=dtype, device=device)
    return mf.quat_to_matrix(torch.as_tensor(imu_in_body_rot, dtype=dtype, device=device))


def initial_state_from_config(
    imu_in_nwu_pos,
    imu_in_nwu_rot,
    config: PoseUKFConfig,
    model_parameters: dyn.UWVParameters,
    imu_in_body_rot=None,
    dtype=torch.float64,
    device=None,
) -> PoseState:
    """Initial state of the first ctor: zero velocity/acceleration/currents,
    biases rotated into the body frame, WGS-84 gravity, (x, y, ψ) blocks
    extracted from the 6×6 model."""
    device = resolve_device(device)
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    rot_ib = _rot_or_eye(imu_in_body_rot, dtype, device)
    gravity = geo.wgs84_gravity(
        t(config.location.latitude), t(config.location.altitude)
    )
    z = lambda n: torch.zeros(n, dtype=dtype, device=device)
    return PoseState(
        position=t(imu_in_nwu_pos),
        orientation=t(imu_in_nwu_rot),
        velocity=z(3),
        acceleration=z(3),
        bias_gyro=rot_ib @ t(config.rotation_rate.bias_offset),
        bias_acc=rot_ib @ t(config.acceleration.bias_offset),
        gravity=gravity.reshape(1).to(dtype),
        inertia=dyn.extract_xy_yaw(t(model_parameters.inertia_matrix)),
        lin_damping=dyn.extract_xy_yaw(t(model_parameters.damping_linear)),
        quad_damping=dyn.extract_xy_yaw(t(model_parameters.damping_quadratic)),
        water_velocity=z(2),
        water_velocity_below=z(2),
        bias_adcp=z(2),
        water_density=t([config.hydrostatics.water_density]),
    )


def _block_setter(c: torch.Tensor):
    def set_block(name, value):
        s = POSE_MANIFOLD.block(name)
        c[s, s] = value

    return set_block


def initial_cov_from_config(
    imu_in_nwu_pos_cov,
    imu_in_nwu_rot_cov,
    config: PoseUKFConfig,
    imu_in_body_rot=None,
    dtype=torch.float64,
    device=None,
) -> torch.Tensor:
    """Blockwise initial covariance."""
    device = resolve_device(device)
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    eye = lambda n: torch.eye(n, dtype=dtype, device=device)
    rot = _rot_or_eye(imu_in_body_rot, dtype, device)
    c = torch.zeros((53, 53), dtype=dtype, device=device)
    put = _block_setter(c)
    put("position", t(imu_in_nwu_pos_cov))
    put("orientation", t(imu_in_nwu_rot_cov))
    put("velocity", eye(3))
    put("acceleration", 10.0 * eye(3))
    gi = t(config.rotation_rate.bias_instability)
    ai = t(config.acceleration.bias_instability)
    put("bias_gyro", rot @ torch.diag(gi**2) @ rot.T)
    put("bias_acc", rot @ torch.diag(ai**2) @ rot.T)
    put("gravity", t([[0.05**2]]))
    mnp = config.model_noise_parameters
    put("inertia", torch.diag(t(mnp.inertia_instability) ** 2))
    put("lin_damping", torch.diag(t(mnp.lin_damping_instability) ** 2))
    put("quad_damping", torch.diag(t(mnp.quad_damping_instability) ** 2))
    wv = config.water_velocity
    put("water_velocity", wv.limits**2 * eye(2))
    put("water_velocity_below", wv.limits**2 * eye(2))
    put("bias_adcp", wv.adcp_bias_limits**2 * eye(2))
    put("water_density", t([[config.hydrostatics.water_density_limits**2]]))
    return c


def process_noise_from_config(
    config: PoseUKFConfig, imu_delta_t: float, imu_in_body_rot=None, dtype=torch.float64, device=None
) -> torch.Tensor:
    """``setProcessNoiseFromConfig``: Euler integration error terms from
    max_jerk, first-order-Markov 2/(τ·dt)·instability² for the rest."""
    device = resolve_device(device)
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    eye = lambda n: torch.eye(n, dtype=dtype, device=device)
    rot = _rot_or_eye(imu_in_body_rot, dtype, device)
    dt = imu_delta_t
    jerk = t(config.max_jerk)
    q = torch.zeros((53, 53), dtype=dtype, device=device)
    put = _block_setter(q)
    put("position", 1.5 * torch.diag(dt**4 * ((1.0 / 6.0) * 0.25 * jerk) ** 2))
    put("velocity", 1.5 * torch.diag(dt**2 * (0.5 * 0.25 * jerk) ** 2))
    put("acceleration", torch.diag((0.25 * jerk) ** 2))
    rw = t(config.rotation_rate.randomwalk)
    put("orientation", rot @ torch.diag(rw**2) @ rot.T)
    gi = t(config.rotation_rate.bias_instability)
    put("bias_gyro", rot @ ((2.0 / (config.rotation_rate.bias_tau * dt)) * torch.diag(gi**2)) @ rot.T)
    ai = t(config.acceleration.bias_instability)
    put("bias_acc", rot @ ((2.0 / (config.acceleration.bias_tau * dt)) * torch.diag(ai**2)) @ rot.T)
    put("gravity", t([[1e-12]]))  # numeric stability only
    mnp = config.model_noise_parameters
    put("inertia", (2.0 / (mnp.inertia_tau * dt)) * torch.diag(t(mnp.inertia_instability) ** 2))
    put(
        "lin_damping",
        (2.0 / (mnp.lin_damping_tau * dt)) * torch.diag(t(mnp.lin_damping_instability) ** 2),
    )
    put(
        "quad_damping",
        (2.0 / (mnp.quad_damping_tau * dt)) * torch.diag(t(mnp.quad_damping_instability) ** 2),
    )
    wv = config.water_velocity
    put("water_velocity", (2.0 / (wv.tau * dt)) * wv.limits**2 * eye(2))
    put("water_velocity_below", (2.0 / (wv.tau * dt)) * wv.limits**2 * eye(2))
    put("bias_adcp", (2.0 / (wv.adcp_bias_tau * dt)) * wv.adcp_bias_limits**2 * eye(2))
    hyd = config.hydrostatics
    put("water_density", t([[(2.0 / (hyd.water_density_tau * dt)) * hyd.water_density_limits**2]]))
    return q


def params_from_config(
    config: PoseUKFConfig,
    model_parameters: dyn.UWVParameters,
    initial_state: PoseState,
    imu_delta_t: float = 0.01,
    imu_in_body_rot=None,
    imu_in_body_trans=None,
    dtype=torch.float64,
    device=None,
) -> PoseUKFParams:
    """``PoseUKFParameter`` population, Markov rest points, process noise."""
    device = resolve_device(device)
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    rot = _rot_or_eye(imu_in_body_rot, dtype, device)
    trans = torch.zeros(3, dtype=dtype, device=device) if imu_in_body_trans is None else t(imu_in_body_trans)
    wv, hyd, mnp = config.water_velocity, config.hydrostatics, config.model_noise_parameters
    return PoseUKFParams(
        imu_in_body=trans,
        gyro_bias_offset=rot @ t(config.rotation_rate.bias_offset),
        gyro_bias_tau=t(config.rotation_rate.bias_tau),
        acc_bias_offset=rot @ t(config.acceleration.bias_offset),
        acc_bias_tau=t(config.acceleration.bias_tau),
        inertia_tau=t(mnp.inertia_tau),
        lin_damping_tau=t(mnp.lin_damping_tau),
        quad_damping_tau=t(mnp.quad_damping_tau),
        water_velocity_tau=t(wv.tau),
        water_velocity_limits=t(wv.limits),
        water_velocity_scale=t(wv.scale),
        adcp_bias_tau=t(wv.adcp_bias_tau),
        atmospheric_pressure=t(hyd.atmospheric_pressure),
        water_density_tau=t(hyd.water_density_tau),
        inertia_offset=initial_state.inertia,
        lin_damping_offset=initial_state.lin_damping,
        quad_damping_offset=initial_state.quad_damping,
        water_density_offset=initial_state.water_density[0],
        model=tree_map(lambda a: t(a), model_parameters),
        projection=geo.make_projection(
            config.location.latitude, config.location.longitude, dtype, device
        ),
        process_noise=process_noise_from_config(config, imu_delta_t, imu_in_body_rot, dtype, device),
    )


def init_from_pose(
    imu_in_nwu_pos,
    imu_in_nwu_pos_cov,
    imu_in_nwu_rot,
    imu_in_nwu_rot_cov,
    config: PoseUKFConfig,
    model_parameters: dyn.UWVParameters,
    imu_delta_t: float = 0.01,
    imu_in_body_rot=None,
    imu_in_body_trans=None,
    dtype=torch.float64,
    device=None,
) -> tuple[PoseUKFState, PoseUKFParams]:
    """First ctor plus ``setProcessNoiseFromConfig``. ``device=None`` builds on
    the card (see ``utils/device.py``); pass ``device="cpu"`` for the CPU."""
    device = resolve_device(device)
    mu = initial_state_from_config(
        imu_in_nwu_pos, imu_in_nwu_rot, config, model_parameters, imu_in_body_rot, dtype, device
    )
    cov = initial_cov_from_config(
        imu_in_nwu_pos_cov, imu_in_nwu_rot_cov, config, imu_in_body_rot, dtype, device
    )
    params = params_from_config(
        config, model_parameters, mu, imu_delta_t, imu_in_body_rot, imu_in_body_trans, dtype, device
    )
    rr = torch.zeros(3, dtype=dtype, device=device)
    return PoseUKFState(mu=mu, cov=cov, rotation_rate=rr), params


def init_from_state(initial_state: PoseState, state_cov, params: PoseUKFParams) -> PoseUKFState:
    """Second ctor: resume from an explicit state and covariance."""
    pos = initial_state.position
    return PoseUKFState(
        mu=initial_state,
        cov=torch.as_tensor(state_cov, dtype=pos.dtype, device=pos.device),
        rotation_rate=torch.zeros(3, dtype=pos.dtype, device=pos.device),
    )


# ---------------------------------------------------------------------------
# process model + prediction
# ---------------------------------------------------------------------------


def _per_field(p, rank: int):
    """A scalar parameter — shared ``()`` or per instance ``(B,)`` — shaped to
    broadcast against a field of rank ``rank`` over leading (…, B) axes."""
    return p.reshape(p.shape + (1,) * rank) if isinstance(p, torch.Tensor) else p


def _process_model(chi: PoseState, rotation_rate, params: PoseUKFParams, dt) -> PoseState:
    """``processModel`` on (2n+1, B)-batched sigma points; ``rotation_rate``
    is (B, 3); ``params`` shared or banked."""
    position = chi.position + dt * chi.velocity
    lat, _ = geo.nav_to_world(params.projection, chi.position[..., 0], chi.position[..., 1])
    earth_rot = geo.earth_rotation_nav(lat).to(chi.position.dtype)
    angular_velocity = mf.quat_rotate(chi.orientation, rotation_rate - chi.bias_gyro) - earth_rot
    orientation = mf.so3_boxplus(chi.orientation, angular_velocity, dt)
    velocity = chi.velocity + dt * chi.acceleration

    def decay(x, offset, tau, rank=1):
        return x + dt * (-1.0 / _per_field(tau, rank)) * (x - offset)

    return PoseState(
        position=position,
        orientation=orientation,
        velocity=velocity,
        acceleration=chi.acceleration,
        bias_gyro=decay(chi.bias_gyro, params.gyro_bias_offset, params.gyro_bias_tau),
        bias_acc=decay(chi.bias_acc, params.acc_bias_offset, params.acc_bias_tau),
        gravity=chi.gravity,
        inertia=decay(chi.inertia, params.inertia_offset, params.inertia_tau, 2),
        lin_damping=decay(chi.lin_damping, params.lin_damping_offset, params.lin_damping_tau, 2),
        quad_damping=decay(chi.quad_damping, params.quad_damping_offset, params.quad_damping_tau, 2),
        water_velocity=decay(chi.water_velocity, 0.0, params.water_velocity_tau),
        water_velocity_below=decay(chi.water_velocity_below, 0.0, params.water_velocity_tau),
        bias_adcp=decay(chi.bias_adcp, 0.0, params.adcp_bias_tau),
        water_density=decay(
            chi.water_density, _per_field(params.water_density_offset, 1), params.water_density_tau
        ),
    )


@per_device
def _noise_masks(device: torch.device):
    """On ``device``: the (53, 53) masks of Q's orientation block and of the
    water currents' four diagonal entries (46–49)."""
    so = POSE_MANIFOLD.block("orientation")
    orient = torch.zeros(53, 53, dtype=torch.bool)
    orient[so, so] = True
    water = torch.zeros(53, dtype=torch.bool)
    water[46:50] = True
    return orient.to(device), torch.diag(water).to(device)


def assemble_process_noise(mu: PoseState, params: PoseUKFParams, dt) -> torch.Tensor:
    """Per-step process noise of ``predictionStepImpl`` for a bank (B, 53, 53):
    rotate the orientation block into the nav frame with the pre-predict
    orientation, inflate the water-current noise with the z-weighted speed,
    scale the whole Q by dt². ``params`` shared or banked. Built by selects,
    not written in place, so that a state batched by ``torch.func.vmap``
    goes into the shared noise."""
    q0 = params.process_noise
    nb = mu.position.shape[0]
    so = POSE_MANIFOLD.block("orientation")
    orient, water = _noise_masks(q0.device)
    rot = mf.quat_to_matrix(mu.orientation)
    block = (rot @ q0[..., so, so] @ rot.transpose(-1, -2)).to(q0.dtype)
    pad = (so.start, 53 - so.stop)
    q = torch.where(orient, torch.nn.functional.pad(block, pad + pad), q0.expand(nb, 53, 53))
    scale = torch.tensor([1.0, 1.0, 10.0], dtype=mu.velocity.dtype, device=mu.velocity.device)
    sv = mu.velocity * scale
    wv_extra = params.water_velocity_scale * (sv * sv).sum(-1) * dt
    q = torch.where(water, (q + wv_extra[:, None, None]).to(q.dtype), q)
    return (dt**2 * q).to(q0.dtype)


def _predict_generic(bstate: PoseUKFState, params: PoseUKFParams, dt) -> PoseUKFState:
    q = assemble_process_noise(bstate.mu, params, dt)
    mu, cov = ukf.predict(
        POSE_MANIFOLD, bstate.mu, bstate.cov,
        lambda chi: _process_model(chi, bstate.rotation_rate, params, dt), q,
    )
    return bstate._replace(mu=mu, cov=cov)


def _solo(fn, state: PoseUKFState, *args):
    """Run a bank function on one filter (a bank of one)."""
    out = fn(tree_map(lambda a: a[None], state), *args)
    if isinstance(out, PoseUKFState):
        return tree_map(lambda a: a[0], out)
    new_state, info = out
    return tree_map(lambda a: a[0], new_state), tree_map(lambda a: a[0], info)


def predict(state: PoseUKFState, params: PoseUKFParams, dt) -> PoseUKFState:
    """``predictionStepImpl`` of one filter: assemble the state-dependent Q,
    then unscented-predict through the process model (generic path)."""
    return _solo(_predict_generic, state, params, dt)


def _fused_route(bstate: PoseUKFState) -> bool:
    """True for a CUDA bank (fused kernels), False for a CPU bank (generic
    path); any other device raises."""
    kind = bstate.cov.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no PoseUKF bank path for device {bstate.cov.device}")
    return kind == "cuda"


def predict_bank(bstate: PoseUKFState, params: PoseUKFParams, dt) -> PoseUKFState:
    """Bank prediction: the fused predict kernel for a CUDA bank (its
    shared-parameter or fully-banked mode), the generic batched path for a
    CPU bank."""
    if _fused_route(bstate):
        from . import pose_fused

        return pose_fused.predict_fused_banked(bstate, params, dt)
    return _predict_generic(bstate, params, dt)


def update_bank(bstate, params, z, meas_cov, h, deps, gate_threshold=None):
    """Bank update with a vector measurement model ``h`` (``deps`` names the
    PoseState fields it reads; ``h`` broadcasts over (2n+1, B) sigma points,
    so it may close over banked parameters). A CUDA bank takes the fused
    generic-h pipeline (K1 sigma deltas, ``h`` in PyTorch, the K4 update
    tail), a CPU bank the generic path."""
    unknown = set(deps) - set(PoseState._fields)
    if unknown:
        raise ValueError(f"deps names unknown PoseState fields: {sorted(unknown)}")
    if _fused_route(bstate):
        from . import pose_update_fused

        return pose_update_fused.update_fused_banked(
            bstate, params, z, meas_cov, h, deps, gate_threshold
        )
    mu, cov, info = ukf.update(
        POSE_MANIFOLD, bstate.mu, bstate.cov, torch.as_tensor(z, dtype=bstate.cov.dtype),
        h, meas_cov, gate_threshold=gate_threshold,
    )
    return bstate._replace(mu=mu, cov=cov), info


# ---------------------------------------------------------------------------
# measurement models (broadcasting over (2n+1, B) sigma points)
# ---------------------------------------------------------------------------

_VELOCITY_DEPS = ("orientation", "velocity")
_ACCELERATION_DEPS = ("orientation", "acceleration", "bias_acc", "gravity")
_PRESSURE_DEPS = ("position", "orientation", "gravity", "water_density")
_WATER_DEPS = ("orientation", "velocity", "water_velocity", "water_velocity_below", "bias_adcp")
_EFFORTS_DEPS = (
    "orientation", "velocity", "acceleration", "inertia", "lin_damping", "quad_damping",
    "water_velocity",
)


def _h_velocity(s: PoseState) -> torch.Tensor:
    """``measurementVelocity``: h = R⁻¹·v."""
    return mf.quat_rotate_inv(s.orientation, s.velocity)


def _h_acceleration(s: PoseState) -> torch.Tensor:
    """``measurementAcceleration``: R⁻¹(a + [0,0,g]) + b_acc."""
    zero = torch.zeros_like(s.gravity)
    g_vec = torch.cat([zero, zero, s.gravity], dim=-1)
    return mf.quat_rotate_inv(s.orientation, s.acceleration + g_vec) + s.bias_acc


def _h_z_position(s: PoseState) -> torch.Tensor:
    return s.position[..., 2:3]


def _h_xy_position(s: PoseState) -> torch.Tensor:
    return s.position[..., :2]


def _h_pressure(atmospheric_pressure, lever: torch.Tensor):
    """``measurementPressureSensor``: p = p_atm − z_sensor·g·ρ; a (B,)
    ``atmospheric_pressure`` gives each instance its own."""

    def h(s: PoseState) -> torch.Tensor:
        sensor_nav = s.position + mf.quat_rotate(s.orientation, lever)
        p = atmospheric_pressure - sensor_nav[..., 2] * s.gravity[..., 0] * s.water_density[..., 0]
        return p[..., None]

    return h


def _h_water_velocity(cell_weighting):
    """``measurementWaterCurrents``: cell-weighted blend of at-vehicle and
    below-vehicle currents plus ADCP bias, IMU frame; a (B,) weighting gives
    each instance its own."""
    if not isinstance(cell_weighting, torch.Tensor):
        cell_weighting = torch.tensor(float(cell_weighting), dtype=torch.float64)
    cw = cell_weighting[..., None]

    def h(s: PoseState) -> torch.Tensor:
        zero = torch.zeros_like(s.water_velocity[..., :1])
        wvb = torch.cat([s.water_velocity_below, zero], dim=-1)
        wv = torch.cat([s.water_velocity, zero], dim=-1)
        wvb_meas = mf.quat_rotate_inv(s.orientation, s.velocity - wvb)
        wv_meas = mf.quat_rotate_inv(s.orientation, s.velocity - wv)
        c = cw.to(s.velocity.dtype).to(s.velocity.device)
        return c * wvb_meas[..., :2] + (1.0 - c) * wv_meas[..., :2] + s.bias_adcp

    return h


def _efforts_measurement(chi: PoseState, params: PoseUKFParams, rotation_rate_body) -> torch.Tensor:
    """``measurementEfforts``: Fossen inverse dynamics with the per-sigma-point
    (x, y, ψ) inertia/damping substituted into the 6×6 model;
    ``rotation_rate_body`` is (3,) or (B, 3); ``params`` shared or banked."""
    m = params.model._replace(
        weight=_per_field(params.model.weight, 1),
        buoyancy=_per_field(params.model.buoyancy, 1),
        inertia_matrix=dyn.embed_xy_yaw(params.model.inertia_matrix, chi.inertia),
        damping_linear=dyn.embed_xy_yaw(params.model.damping_linear, chi.lin_damping),
        damping_quadratic=dyn.embed_xy_yaw(params.model.damping_quadratic, chi.quad_damping),
    )
    q = chi.orientation
    zero = torch.zeros_like(chi.water_velocity[..., :1])
    water_velocity = torch.cat([chi.water_velocity, zero], dim=-1)
    rr = rotation_rate_body
    velocity_body = mf.quat_rotate_inv(q, chi.velocity) - mf._cross(rr, params.imu_in_body)
    velocity_body = velocity_body - mf.quat_rotate_inv(q, water_velocity)
    vel6 = torch.cat([velocity_body, rr.expand_as(velocity_body)], dim=-1)
    acceleration_body = mf.quat_rotate_inv(q, chi.acceleration) - mf._cross(
        rr, mf._cross(rr, params.imu_in_body)
    )
    acc6 = torch.cat([acceleration_body, torch.zeros_like(acceleration_body)], dim=-1)
    return dyn.calc_efforts(m, acc6, vel6, q)


def get_rotation_rate(state: PoseUKFState, params: PoseUKFParams) -> torch.Tensor:
    """``getRotationRate``: bias- and earth-rate-compensated body rate."""
    mu = state.mu
    lat, _ = geo.nav_to_world(params.projection, mu.position[..., 0], mu.position[..., 1])
    earth_rot = geo.earth_rotation_nav(lat).to(mu.position.dtype)
    return state.rotation_rate - mu.bias_gyro - mf.quat_rotate_inv(mu.orientation, earth_rot)


def get_rotation_rate_bank(bstate: PoseUKFState, params: PoseUKFParams) -> torch.Tensor:
    """(B, 3) per-instance :func:`get_rotation_rate`."""
    return get_rotation_rate(bstate, params)


def integrate_rotation_rate(state: PoseUKFState, z: torch.Tensor) -> PoseUKFState:
    """Rotation rates are a process input, not an update."""
    return state._replace(rotation_rate=z)


# ---------------------------------------------------------------------------
# bank updates: fused kernel on CUDA, generic path on CPU
# ---------------------------------------------------------------------------


def _fused_update(model, bstate, z, meas_cov, gate_threshold=None, **kw):
    from . import pose_update_fused

    return pose_update_fused.update_model_fused_banked(
        model, bstate, z, meas_cov, gate_threshold, **kw
    )


def update_velocity_bank(bstate, params, z, meas_cov):
    """DVL velocity, h = R⁻¹·v."""
    if _fused_route(bstate):
        return _fused_update("velocity", bstate, z, meas_cov)
    return update_bank(bstate, params, z, meas_cov, _h_velocity, _VELOCITY_DEPS)


def update_acceleration_bank(bstate, params, z, meas_cov):
    """IMU specific force, h = R⁻¹(a + [0,0,g]) + b_acc."""
    if _fused_route(bstate):
        return _fused_update("acceleration", bstate, z, meas_cov)
    return update_bank(bstate, params, z, meas_cov, _h_acceleration, _ACCELERATION_DEPS)


def update_z_position_bank(bstate, params, z, meas_cov):
    """Depth."""
    if _fused_route(bstate):
        return _fused_update("z_position", bstate, z, meas_cov)
    return update_bank(bstate, params, z, meas_cov, _h_z_position, ("position",))


def update_xy_position_bank(bstate, params, z, meas_cov, gate_threshold=None):
    """XY position; ``gate_threshold=ukf.D2P95`` for GPS fixes."""
    if _fused_route(bstate):
        return _fused_update("xy_position", bstate, z, meas_cov, gate_threshold)
    return update_bank(bstate, params, z, meas_cov, _h_xy_position, ("position",), gate_threshold)


def update_pressure_bank(bstate, params, z, meas_cov, pressure_sensor_in_imu=None):
    """Hydrostatic pressure, p = p_atm − z_sensor·g·ρ. A (B,)
    ``params.atmospheric_pressure`` gives each instance its own (the fused
    kernel's banked-aux form)."""
    dtype, device = bstate.cov.dtype, bstate.cov.device
    lever = (
        torch.zeros(3, dtype=dtype, device=device)
        if pressure_sensor_in_imu is None
        else torch.as_tensor(pressure_sensor_in_imu, dtype=dtype, device=device)
    )
    p_atm = params.atmospheric_pressure.to(dtype)
    if _fused_route(bstate):
        if p_atm.ndim >= 1:
            nb = bstate.cov.shape[0]
            aux_bank = torch.cat([p_atm.reshape(-1, 1).expand(nb, 1), lever.expand(nb, 3)], dim=1)
            return _fused_update("pressure", bstate, z, meas_cov, aux_bank=aux_bank)
        return _fused_update("pressure", bstate, z, meas_cov, aux=(p_atm, *lever.unbind()))
    return update_bank(bstate, params, z, meas_cov, _h_pressure(p_atm, lever), _PRESSURE_DEPS)


def update_water_velocity_bank(bstate, params, z, meas_cov, cell_weighting):
    """ADCP water current, χ²-95 gated; ``cell_weighting`` is a shared
    scalar or (B,) per instance."""
    cw = torch.as_tensor(cell_weighting, dtype=bstate.cov.dtype, device=bstate.cov.device)
    if _fused_route(bstate):
        if cw.ndim == 1:
            return _fused_update("water_velocity", bstate, z, meas_cov, ukf.D2P95, aux_bank=cw[:, None])
        return _fused_update("water_velocity", bstate, z, meas_cov, ukf.D2P95, aux=(cw,))
    return update_bank(
        bstate, params, z, meas_cov, _h_water_velocity(cw), _WATER_DEPS, ukf.D2P95
    )


def update_body_efforts_bank(bstate, params, z, meas_cov, rotation_rate_body):
    """Model-aided effort update (full mode). ``rotation_rate_body`` is the
    compensated body rate, (3,) shared or (B, 3) per instance. On a CUDA
    bank a shared vehicle model runs in-kernel (K3); a banked one (or a
    banked ``imu_in_body``) takes the generic-h pipeline (K1, ``h``, K4)."""
    rr = torch.as_tensor(rotation_rate_body, dtype=bstate.cov.dtype, device=bstate.cov.device)
    banked_model = params.model.inertia_matrix.ndim == 3 or params.imu_in_body.ndim == 2
    if _fused_route(bstate) and not banked_model:
        from . import pose_update_fused

        nb = bstate.cov.shape[0]
        return _fused_update(
            "body_efforts", bstate, z, meas_cov,
            aux_bank=rr.expand(nb, 3),
            mscal=pose_update_fused._efforts_model_scal(params, bstate.cov.dtype),
        )
    return update_bank(
        bstate, params, z, meas_cov, lambda s: _efforts_measurement(s, params, rr), _EFFORTS_DEPS
    )


def _geographic_xy(params, lat, lon, orientation, gps_in_body, nb=None):
    """GPS fix projected to the NWU plane, minus the antenna lever arm
    rotated by ``orientation`` (``PoseUKF.cpp:567-579``)."""
    x, y = geo.world_to_nav(params.projection, lat, lon)
    if nb is not None:
        x, y = x.expand(nb), y.expand(nb)
    projected = torch.stack([x, y], dim=-1).to(orientation.dtype)
    if gps_in_body is not None:
        g = torch.as_tensor(gps_in_body, dtype=orientation.dtype, device=orientation.device)
        projected = projected - mf.quat_rotate(orientation, g)[..., :2]
    return projected


def update_geographic_position_bank(bstate, params, lat, lon, meas_cov, gps_in_body=None):
    """GPS fixes: each instance's (lat, lon) — (B,), or scalars shared by the
    bank — projected through its own (shared or banked) anchor, the lever
    arm ``gps_in_body`` ((3,) or (B, 3)) rotated by its own mean
    orientation, then the χ²-95-gated XY update."""
    dtype, device, nb = bstate.cov.dtype, bstate.cov.device, bstate.cov.shape[0]
    lat = torch.as_tensor(lat, dtype=dtype, device=device).expand(nb)
    lon = torch.as_tensor(lon, dtype=dtype, device=device).expand(nb)
    projected = _geographic_xy(params, lat, lon, bstate.mu.orientation, gps_in_body, nb)
    return update_xy_position_bank(bstate, params, projected, meas_cov, ukf.D2P95)


def update_delayed_position_bank(bstate, params, z, meas_cov, delayed_position):
    """Active delayed-position path (``PoseUKF.cpp:514-527``): shift each
    instance's XY fix by its own (current − delayed) position, then the XY
    update. ``delayed_position`` is (B, 2) or (2,)."""
    dtype, device = bstate.cov.dtype, bstate.cov.device
    shifted = torch.as_tensor(z, dtype=dtype, device=device) + (
        bstate.mu.position[:, :2] - torch.as_tensor(delayed_position, dtype=dtype, device=device)
    )
    return update_xy_position_bank(bstate, params, shifted, meas_cov)


# ---------------------------------------------------------------------------
# solo updates: one filter, generic path
# ---------------------------------------------------------------------------


def _solo_update(state, params, z, meas_cov, h, gate_threshold=None):
    def fn(bstate):
        mu, cov, info = ukf.update(
            POSE_MANIFOLD, bstate.mu, bstate.cov, torch.as_tensor(z)[None], h, meas_cov,
            gate_threshold=gate_threshold,
        )
        return bstate._replace(mu=mu, cov=cov), info

    return _solo(fn, state)


def update_velocity(state, params, z, meas_cov):
    return _solo_update(state, params, z, meas_cov, _h_velocity)


def update_acceleration(state, params, z, meas_cov):
    return _solo_update(state, params, z, meas_cov, _h_acceleration)


def update_z_position(state, params, z, meas_cov):
    return _solo_update(state, params, z, meas_cov, _h_z_position)


def update_xy_position(state, params, z, meas_cov, gate_threshold=None):
    return _solo_update(state, params, z, meas_cov, _h_xy_position, gate_threshold)


def update_pressure(state, params, z, meas_cov, pressure_sensor_in_imu=None):
    dtype, device = state.cov.dtype, state.cov.device
    lever = (
        torch.zeros(3, dtype=dtype, device=device)
        if pressure_sensor_in_imu is None
        else torch.as_tensor(pressure_sensor_in_imu, dtype=dtype, device=device)
    )
    return _solo_update(state, params, z, meas_cov, _h_pressure(params.atmospheric_pressure, lever))


def update_water_velocity(state, params, z, meas_cov, cell_weighting):
    return _solo_update(
        state, params, z, meas_cov, _h_water_velocity(cell_weighting), ukf.D2P95
    )


def _constrain_velocity_measurement(chi: PoseState, params: PoseUKFParams, rotation_rate_body, water_velocity,
                                    orientation, acceleration_body) -> torch.Tensor:
    """``constrainVelocity`` (``PoseUKF.cpp:199-219``): only the velocity
    varies per sigma point; the orientation, the body acceleration and the
    water current are frozen at the current mean. It uses the base vehicle
    model as JAX pins it (the reference mutates a shared DynamicModel, so
    there it would follow the last ``setUWVParameters`` call)."""
    rr = rotation_rate_body
    velocity_body = mf.quat_rotate_inv(orientation, chi.velocity) - mf._cross(rr, params.imu_in_body)
    velocity_body = velocity_body - mf.quat_rotate_inv(orientation, water_velocity)
    vel6 = torch.cat([velocity_body, rr.expand_as(velocity_body)], dim=-1)
    acc6 = torch.cat([acceleration_body.expand_as(velocity_body), torch.zeros_like(velocity_body)], dim=-1)
    return dyn.calc_efforts(params.model, acc6, vel6, orientation)


def update_body_efforts(state, params, z, meas_cov, only_affect_velocity: bool = False):
    """Model-aided effort measurement (``PoseUKF.cpp:581-602``): the full
    model, or with ``only_affect_velocity`` the velocity-only constraint."""
    rr_body = get_rotation_rate(state, params)
    if only_affect_velocity:
        mu = state.mu
        water_velocity = torch.cat([mu.water_velocity, torch.zeros_like(mu.water_velocity[:1])])
        acceleration_body = mf.quat_rotate_inv(mu.orientation, mu.acceleration) - mf._cross(
            rr_body, mf._cross(rr_body, params.imu_in_body)
        )

        def h(chi):
            return _constrain_velocity_measurement(chi, params, rr_body, water_velocity, mu.orientation,
                                                   acceleration_body)
    else:

        def h(chi):
            return _efforts_measurement(chi, params, rr_body)

    return _solo_update(state, params, z, meas_cov, h)


def update_geographic_position(state, params, lat, lon, meas_cov, gps_in_body=None):
    """GPS fix (``PoseUKF.cpp:567-579``): project to the NWU plane, correct
    the antenna lever arm with the current orientation, χ²-95 gate."""
    dtype, device = state.cov.dtype, state.cov.device
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    projected = _geographic_xy(params, t(lat), t(lon), state.mu.orientation, gps_in_body)
    return update_xy_position(state, params, projected, meas_cov, ukf.D2P95)


def update_delayed_position(state, params, z, meas_cov, delayed_position):
    """Active delayed-position path (``PoseUKF.cpp:514-527``): shift the fix
    by (current − delayed) position, then a standard XY update."""
    dtype, device = state.cov.dtype, state.cov.device
    shifted = torch.as_tensor(z, dtype=dtype, device=device) + (
        state.mu.position[:2] - torch.as_tensor(delayed_position, dtype=dtype, device=device)
    )
    return update_xy_position(state, params, shifted, meas_cov)


# ---------------------------------------------------------------------------
# visual markers: the 59-DOF augmentation (PoseUKF.cpp:613-654)
# ---------------------------------------------------------------------------


def _visual_landmark_measurement(chi: PoseStateWithMarker, feature_pos, cam_q, cam_p) -> torch.Tensor:
    """``measurementVisualLandmark`` (``PoseUKF.cpp:233-243``): feature →
    nav → camera frame → S² bearing."""
    cam_in_nav_q, cam_in_nav_p = mf.affine_mul(chi.orientation, chi.position, cam_q, cam_p)
    nav_in_cam_q, nav_in_cam_p = mf.affine_inv(cam_in_nav_q, cam_in_nav_p)
    feature_nav = mf.affine_apply(chi.marker_orientation, chi.marker_position, feature_pos)
    return mf.s2_normalize(mf.affine_apply(nav_in_cam_q, nav_in_cam_p, feature_nav))


def _update_visual_features_generic(bstate: PoseUKFState, feats, fcovs, fpos, mpos, mrot, cov_marker, camera,
                                    cam_p, cam_q):
    """The marker update of a bank on the generic path: feats (B, K, 2)
    pixels, fcovs (B, K, 2, 2), fpos (K, 3) in the marker frame, the marker
    pose (B, 3) / (B, 4), cov_marker (6, 6), the camera extrinsics (3,) /
    (4,). The filter ⊕ the marker pose with zero cross-covariance, one S²
    update per corner on the 59-DOF manifold, the filter block marginalized
    back out; the infos on a (B, K) axis."""
    k = feats.shape[1]
    _check_corners(k, fpos.shape[0], fcovs.shape[1], "update_visual_features")
    aug_mu = PoseStateWithMarker(*bstate.mu, marker_position=mpos, marker_orientation=mrot)
    aug_cov = ukf.augment_covariance(bstate.cov, cov_marker)
    z_all, r_all = pixel_to_s2(feats, camera), pixel_cov_to_s2(fcovs, camera)
    infos = []
    for i in range(k):
        h = lambda chi, fp=fpos[i]: _visual_landmark_measurement(chi, fp, cam_q, cam_p)
        aug_mu, aug_cov, info = ukf.update(POSE_MARKER_MANIFOLD, aug_mu, aug_cov, z_all[:, i], h, r_all[:, i],
                                           meas_manifold=mf.S2_MANIFOLD)
        infos.append(info)
    info = ukf.UpdateInfo(*(torch.stack(leaves, dim=1) for leaves in zip(*infos)))
    return bstate._replace(mu=PoseState(*aug_mu[:14]), cov=aug_cov[:, :53, :53].contiguous()), info


def update_visual_features(state: PoseUKFState, params: PoseUKFParams, marker_features, feature_covs,
                           feature_positions, marker_position, marker_orientation, cov_marker_pose,
                           camera: CameraConfiguration, camera_in_imu_position, camera_in_imu_orientation):
    """Visual-marker update of one filter via the 59-DOF augmentation
    (``PoseUKF.cpp:613-654``): marker_features (K, 2) pixels, feature_covs
    (K, 2, 2), feature_positions (K, 3) in the marker frame; each pixel
    becomes a pinhole bearing and its covariance is divided by
    [[fx², fx·fy], [fx·fy, fy²]]. Returns the state and the per-corner
    ``UpdateInfo`` stacked on a leading (K,) axis; K = 0 or mismatched
    counts raise ``ValueError``. The model reads no parameter."""
    c = state.cov
    feats, fcovs, fpos = _as(marker_features, c), _as(feature_covs, c), _as(feature_positions, c)
    _check_corners(feats.shape[0], fpos.shape[0], fcovs.shape[0], "update_visual_features")
    return _solo(_update_visual_features_generic, state, feats[None], fcovs[None], fpos,
                 _as(marker_position, c)[None], _as(marker_orientation, c)[None], _as(cov_marker_pose, c), camera,
                 _as(camera_in_imu_position, c), _as(camera_in_imu_orientation, c))


def update_visual_features_bank(bstate: PoseUKFState, params: PoseUKFParams, marker_features, feature_covs,
                                feature_positions, marker_position, marker_orientation, cov_marker_pose,
                                camera: CameraConfiguration, camera_in_imu_position, camera_in_imu_orientation):
    """Bank visual-marker update. ``marker_features`` / ``feature_covs`` are
    shared (K, …) or per instance (B, K, …), the marker pose's mean shared
    (3,) / (4,) or per instance (B, 3) / (B, 4); the marker geometry, the
    marker pose's covariance and the camera are shared. The model reads no
    parameter, so a banked ``params`` works unchanged. A CUDA bank runs the
    augmentation, the K chained corner updates and the marginalization in
    one K11 launch (``models/pose_marker_fused.py``), a CPU bank the generic
    path. Returns the state and the infos on a (B, K) axis."""
    if _fused_route(bstate):
        from . import pose_marker_fused

        return pose_marker_fused.update_visual_features_fused_banked(
            bstate, marker_features, feature_covs, feature_positions, marker_position, marker_orientation,
            cov_marker_pose, camera, camera_in_imu_position, camera_in_imu_orientation)
    nb, c = bstate.cov.shape[0], bstate.cov
    feats, fcovs, fpos = _as(marker_features, c), _as(feature_covs, c), _as(feature_positions, c)
    if feats.ndim == 2:
        feats = feats[None].expand(nb, *feats.shape)
    k = feats.shape[1]
    _check_corners(k, fpos.shape[0], fcovs.shape[-3] if fcovs.ndim > 2 else k,  # one (2, 2) serves every corner
                   "update_visual_features")
    return _update_visual_features_generic(
        bstate, feats, fcovs.expand(nb, k, 2, 2), fpos, _as(marker_position, c).expand(nb, 3),
        _as(marker_orientation, c).expand(nb, 4), _as(cov_marker_pose, c), camera, _as(camera_in_imu_position, c),
        _as(camera_in_imu_orientation, c))


# ---------------------------------------------------------------------------
# the delayed-state surface (PoseUKF.cpp:467-473, 529-557, 656-691)
# ---------------------------------------------------------------------------


class PoseStateWithDelayedPosition(NamedTuple):
    """``MTK_BUILD_MANIFOLD(PoseStateWithDelayedPosition, ...)``
    (``src/PoseUKF.cpp:248-252``), flattened: the 53 DOF of
    :class:`PoseState`, then the delayed XY position (55 DOF)."""

    position: torch.Tensor
    orientation: torch.Tensor
    velocity: torch.Tensor
    acceleration: torch.Tensor
    bias_gyro: torch.Tensor
    bias_acc: torch.Tensor
    gravity: torch.Tensor
    inertia: torch.Tensor
    lin_damping: torch.Tensor
    quad_damping: torch.Tensor
    water_velocity: torch.Tensor
    water_velocity_below: torch.Tensor
    bias_adcp: torch.Tensor
    water_density: torch.Tensor
    delayed_position: torch.Tensor  # (2,)


POSE_DELAYED_MANIFOLD = mf.make_manifold(*POSE_MANIFOLD.fields, mf.Field("delayed_position", "vec", 2))
if POSE_DELAYED_MANIFOLD.dof != 55:
    raise AssertionError("PoseStateWithDelayedPosition must have 55 tangent DOF")


def _augmented_delayed_generic(bstate: PoseUKFState, z, meas_cov, delayed_position, cov_delayed_position):
    """The 55-DOF augmented delayed fix of a bank: z (B, 2), meas_cov (2, 2)
    or (B, 2, 2), delayed_position (B, 2), cov_delayed_position (2, 2) or
    (B, 2, 2). The filter ⊕ the delayed position with zero cross-covariance,
    the delayed block observed through the shift identity anchored at each
    instance's current mean position, the filter block marginalized back."""
    aug_mu = PoseStateWithDelayedPosition(*bstate.mu, delayed_position=delayed_position)
    aug_cov = ukf.augment_covariance(bstate.cov, cov_delayed_position)
    current_xy = bstate.mu.position[:, :2]

    def h(chi: PoseStateWithDelayedPosition):
        return chi.delayed_position + (chi.position[..., :2] - current_xy)

    aug_mu, aug_cov, info = ukf.update(POSE_DELAYED_MANIFOLD, aug_mu, aug_cov, z, h, meas_cov)
    return bstate._replace(mu=PoseState(*aug_mu[:14]), cov=aug_cov[:, :53, :53].contiguous()), info


def update_delayed_position_with_augmentation(state: PoseUKFState, params: PoseUKFParams, z, meas_cov,
                                              delayed_position, cov_delayed_position):
    """The state-augmentation delayed-position update the reference designed
    but left disabled (``integrateDelayedPositionMeasurementWithStateAugmentation``,
    ``src/PoseUKF.cpp:529-557``): augment with the delayed position, observe
    it through z ≈ delayed + (position − current mean position)
    (``measurementDelayedPosition``, ``:254-259``), marginalize back. Unlike
    the shift path it uses the delayed position's own uncertainty."""
    c = state.cov
    return _solo(_augmented_delayed_generic, state, _as(z, c)[None], _as(meas_cov, c), _as(delayed_position, c)[None],
                 _as(cov_delayed_position, c))


def update_delayed_position_with_augmentation_bank(bstate: PoseUKFState, params: PoseUKFParams, z, meas_cov,
                                                   delayed_position, cov_delayed_position):
    """Bank form of :func:`update_delayed_position_with_augmentation`: every
    measurement operand shared or per instance, broadcast to the bank. One
    banked update at n = 55 (K1 carries its sigma deltas on a CUDA bank), no
    loop over instances."""
    nb, c = bstate.cov.shape[0], bstate.cov
    return _augmented_delayed_generic(
        bstate, _as(z, c).expand(nb, 2), _as(meas_cov, c).expand(nb, 2, 2), _as(delayed_position, c).expand(nb, 2),
        _as(cov_delayed_position, c).expand(nb, 2, 2))


def push_delayed_state(buffer: delayed_states.DelayedStates, state: PoseUKFState,
                       filter_ts_us) -> delayed_states.DelayedStates:
    """Record the current XY position and its covariance block in the
    delayed-state buffer — the prediction-side bookkeeping the reference
    sketches at ``src/PoseUKF.cpp:467-473``."""
    s = POSE_MANIFOLD.block("position")
    xy_cov = state.cov[..., s, s][..., :2, :2]
    return delayed_states.push(buffer, filter_ts_us, state.mu.position[..., :2], xy_cov)


def push_delayed_state_bank(buffer: delayed_states.DelayedStates, bstate: PoseUKFState,
                            filter_ts_us) -> delayed_states.DelayedStates:
    """Bank form of :func:`push_delayed_state`: ``buffer`` carries a leading
    bank axis on every leaf (``parallel.bank.replicate(delayed_states.make_buffer(...), B)``);
    ``filter_ts_us`` is shared or (B,)."""
    return push_delayed_state(buffer, bstate, filter_ts_us)


def _buffered(update_xy, state, params, buffer, filter_ts_us, z, meas_cov, delay_seconds):
    """The buffered delayed fix on one filter or a bank (``update_xy`` is the
    solo or the bank XY update): closest-state lookup, shift identity, χ²-95
    gate; ``found`` and the gate as masked selects."""
    c = state.cov
    ts = filter_ts_us - delayed_states.from_seconds(delay_seconds)
    delayed_xy, _, found = delayed_states.closest(buffer, ts)
    shifted = _as(z, c) + (state.mu.position[..., :2] - delayed_xy)
    new_state, info = update_xy(state, params, shifted, meas_cov, ukf.D2P95)
    keep = info.accepted & found
    out = select_where(keep, new_state, state)._replace(rotation_rate=state.rotation_rate)
    # with found False the lookup, and so the innovation and NIS, mean nothing:
    # neutralize them so NIS monitoring never records a phantom update
    info = ukf.UpdateInfo(
        mahalanobis2=torch.where(found, info.mahalanobis2, torch.zeros_like(info.mahalanobis2)),
        accepted=keep,
        innovation=torch.where(found[..., None], info.innovation, torch.zeros_like(info.innovation)),
    )
    return out, info, found


def update_delayed_position_buffered(state: PoseUKFState, params: PoseUKFParams,
                                     buffer: delayed_states.DelayedStates, filter_ts_us, z, meas_cov, delay_seconds):
    """Out-of-sequence XY fix through the delayed-state buffer — the
    ``integrateDelayedMeasurement`` path (``src/PoseUKF.cpp:656-683``): look
    up the filter position closest to (now − delay), anchor the fix through
    the shift identity, χ²-95 gate. Returns (state, info, found); found False
    (the delay beyond the buffer's horizon) leaves the state untouched, as
    the reference's bool return does. Nothing is read back to the host."""
    return _buffered(update_xy_position, state, params, buffer, filter_ts_us, z, meas_cov, delay_seconds)


def update_delayed_position_buffered_bank(bstate: PoseUKFState, params: PoseUKFParams,
                                          buffer: delayed_states.DelayedStates, filter_ts_us, z, meas_cov,
                                          delay_seconds):
    """Bank form of :func:`update_delayed_position_buffered` over
    per-instance buffers (a leading bank axis on every leaf): ``z`` (B, 2)
    or (2,), ``delay_seconds`` a scalar or (B,) (per-vehicle latency). The
    XY update is the bank's (K3 on a CUDA bank). Instances whose delay
    exceeds their buffer's horizon are left untouched with neutralized info."""
    return _buffered(update_xy_position_bank, bstate, params, buffer, filter_ts_us, z, meas_cov, delay_seconds)


def reset_with_external_pose(state: PoseUKFState, position, orientation) -> PoseUKFState:
    """``resetFilterWithExternalPose`` (``PoseUKF.cpp:685-691``): overwrite
    the pose sub-state, keep everything else including the covariance."""
    c = state.cov
    return state._replace(mu=state.mu._replace(position=_as(position, c), orientation=_as(orientation, c)))


# ---------------------------------------------------------------------------
# the reference's class API (src/PoseUKF.hpp:91-191)
# ---------------------------------------------------------------------------


class PoseUKF:
    """One filter behind the reference's class API, over the solo functions
    above (banks use the ``*_bank`` functions). The constructor builds on the
    card unless given ``device="cpu"`` (``utils/device.py``), in ``dtype``;
    measurements are checked on the host (``utils/validation``) and then
    moved to the filter's device and dtype."""

    def __init__(self, imu_in_nwu_pos, imu_in_nwu_pos_cov, imu_in_nwu_rot, imu_in_nwu_rot_cov,
                 config: PoseUKFConfig, model_parameters: dyn.UWVParameters, imu_delta_t: float = 0.01,
                 imu_in_body_rot=None, imu_in_body_trans=None, dtype=torch.float64, device=None):
        self.state, self.params = init_from_pose(
            imu_in_nwu_pos, imu_in_nwu_pos_cov, imu_in_nwu_rot, imu_in_nwu_rot_cov, config, model_parameters,
            imu_delta_t, imu_in_body_rot, imu_in_body_trans, dtype, device,
        )
        self._delayed_buffer = None
        self._filter_ts = 0

    @classmethod
    def from_state(cls, initial_state: PoseState, state_cov, params: PoseUKFParams, dtype=torch.float64,
                   device=None) -> "PoseUKF":
        """Second ctor: resume from an explicit state, covariance and
        parameters, moved to ``device`` (``None``: the card) and ``dtype``."""
        device = resolve_device(device)

        def to(a):
            if not isinstance(a, torch.Tensor):
                return a
            return a.to(device=device, dtype=dtype if a.is_floating_point() else a.dtype)

        obj = cls.__new__(cls)
        obj.params = tree_map(to, params)
        obj.state = init_from_state(tree_map(to, initial_state), to(torch.as_tensor(state_cov)), obj.params)
        obj._delayed_buffer = None
        obj._filter_ts = 0
        return obj

    def _t(self, value) -> torch.Tensor:
        return _as(value, self.state.cov)

    def set_process_noise_from_config(self, config: PoseUKFConfig, imu_delta_t: float, imu_in_body_rot=None) -> None:
        """``setProcessNoiseFromConfig``; Q is pinned to the filter's dtype
        and device (a float64 Q would promote a float32 filter's covariance
        on the next predict)."""
        c = self.state.cov
        self.params = self.params._replace(
            process_noise=process_noise_from_config(config, imu_delta_t, imu_in_body_rot, c.dtype, c.device))

    def set_process_noise_covariance(self, q) -> None:
        """The filter base class's raw-Q setter (``setProcessNoiseCovariance``,
        called at ``src/PoseUKF.cpp:438``), pinned to the filter's dtype."""
        self.params = self.params._replace(process_noise=self._t(q))

    def _upd(self, fn, mu, cov, *args) -> ukf.UpdateInfo:
        check_measurement(mu, cov)
        self.state, info = fn(self.state, self.params, self._t(mu), self._t(cov), *args)
        return info

    def integrate_velocity(self, mu, cov):
        return self._upd(update_velocity, mu, cov)

    def integrate_acceleration(self, mu, cov):
        return self._upd(update_acceleration, mu, cov)

    def integrate_rotation_rate(self, mu, cov=None) -> None:
        if cov is not None:
            check_measurement(mu, cov)
        self.state = integrate_rotation_rate(self.state, self._t(mu))

    def integrate_z_position(self, mu, cov):
        return self._upd(update_z_position, mu, cov)

    def integrate_xy_position(self, mu, cov):
        return self._upd(update_xy_position, mu, cov)

    def integrate_delayed_position(self, mu, cov, delayed_position):
        return self._upd(update_delayed_position, mu, cov, self._t(delayed_position))

    def integrate_pressure(self, mu, cov, pressure_sensor_in_imu=None):
        lever = None if pressure_sensor_in_imu is None else self._t(pressure_sensor_in_imu)
        return self._upd(update_pressure, mu, cov, lever)

    def integrate_geographic_position(self, lat, lon, cov, gps_in_body=None):
        check_measurement(np.asarray([lat, lon], np.float64), cov)
        g = None if gps_in_body is None else self._t(gps_in_body)
        self.state, info = update_geographic_position(self.state, self.params, self._t(lat), self._t(lon),
                                                      self._t(cov), g)
        return info

    def integrate_body_efforts(self, mu, cov, only_affect_velocity: bool = False):
        return self._upd(update_body_efforts, mu, cov, only_affect_velocity)

    def integrate_water_velocity(self, mu, cov, cell_weighting):
        return self._upd(update_water_velocity, mu, cov, cell_weighting)

    def integrate_visual_features(self, marker_features, feature_covs, feature_positions, marker_position,
                                  marker_orientation, cov_marker_pose, camera: CameraConfiguration,
                                  camera_in_imu_position, camera_in_imu_orientation):
        for feature, feature_cov in zip(marker_features, feature_covs):
            check_measurement(feature, feature_cov)
        self.state, info = update_visual_features(
            self.state, self.params, marker_features, feature_covs, feature_positions, marker_position,
            marker_orientation, cov_marker_pose, camera, camera_in_imu_position, camera_in_imu_orientation)
        return info

    def setup_delayed_state_buffer(self, maximum_delay: float, capacity: int = 256) -> None:
        """``setupDelayedStateBuffer`` (``src/PoseUKF.hpp:130-133``): allocate
        the XY delayed-state buffer on the filter's device; every
        :meth:`prediction_step` then records the position block
        (``src/PoseUKF.cpp:467-473``)."""
        c = self.state.cov
        self._delayed_buffer = delayed_states.make_buffer(capacity, 2, maximum_delay, c.dtype, c.device)
        self._filter_ts = delayed_states.from_seconds(0.0)

    def prediction_step(self, dt: float) -> None:
        self.state = predict(self.state, self.params, dt)
        if self._delayed_buffer is not None:
            self._filter_ts = self._filter_ts + delayed_states.from_seconds(dt)
            self._delayed_buffer = push_delayed_state(self._delayed_buffer, self.state, self._filter_ts)

    def integrate_delayed_measurement(self, mu, cov, delay: float) -> bool:
        """``integrateDelayedMeasurement`` (``src/PoseUKF.cpp:656-683``): an
        out-of-sequence XY fix through the delayed-state buffer; False when
        the delay exceeds the buffer's horizon (one read back to the host)."""
        if self._delayed_buffer is None:
            raise RuntimeError("setup_delayed_state_buffer was not called")
        check_measurement(mu, cov)
        self.state, _, found = update_delayed_position_buffered(
            self.state, self.params, self._delayed_buffer, self._filter_ts, self._t(mu), self._t(cov), delay)
        return bool(found)

    def integrate_delayed_position_with_augmentation(self, mu, cov, delayed_position, cov_delayed_position):
        return self._upd(update_delayed_position_with_augmentation, mu, cov, self._t(delayed_position),
                         self._t(cov_delayed_position))

    def reset_filter_with_external_pose(self, position, orientation) -> None:
        self.state = reset_with_external_pose(self.state, position, orientation)

    def get_rotation_rate(self) -> torch.Tensor:
        return get_rotation_rate(self.state, self.params)

    @property
    def mu(self) -> PoseState:
        return self.state.mu

    @property
    def sigma(self) -> torch.Tensor:
        return self.state.cov

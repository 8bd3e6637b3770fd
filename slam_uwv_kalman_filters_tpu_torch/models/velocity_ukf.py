"""VelocityUKF — the model-aided velocity filter; counterpart of
``slam_uwv_kalman_filters_tpu/models/velocity_ukf.py`` (reference
``VelocityUKF.hpp`` / ``src/VelocityUKF.cpp``).

A 4-DOF UKF over {velocity ℝ³, z_position ℝ¹} whose process model is the
vehicle's forward dynamics: each sigma point takes one step of the Fossen
simulator driven by the latest thruster efforts and gyro rates
(``VelocityUKF.cpp:6-33``). The reference's two stateful simulators become
explicit state: the orientation tracker lives in :class:`VelocityUKFState`,
and the per-sigma-point simulation is a function of the (9, B) sigma points.
Gyro and effort "measurements" are cached inputs of the next prediction
(``VelocityUKF.cpp:87-104``); DVL and pressure are UKF updates.

Bank functions take a leading bank axis on every state leaf. A bank on the
card with one shared parameter set takes the whole-step kernel K6
(``models/velocity_fused.py``, float32 or float64); a CPU bank, and a
banked-parameter sweep, the generic batched path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import dynamics as dyn
from ..ops import manifolds as mf
from ..ops import ukf
from ..parallel.bank import tree_map
from ..utils.device import resolve_device
from ..utils.validation import check_measurement

__all__ = [
    "VelocityState",
    "VELOCITY_MANIFOLD",
    "VelocityUKFState",
    "VelocityUKFParams",
    "init",
    "initial_filter_state",
    "default_process_noise",
    "predict",
    "predict_bank",
    "update_dvl",
    "update_dvl_bank",
    "update_pressure",
    "update_pressure_bank",
    "integrate_gyro",
    "integrate_body_efforts",
    "VelocityUKF",
]


class VelocityState(NamedTuple):
    """``MTK_BUILD_MANIFOLD(VelocityState, …)`` of ``VelocityUKF.hpp:24-27``."""

    velocity: torch.Tensor  # (3,) body-frame linear velocity
    z_position: torch.Tensor  # (1,) depth coordinate (z in the nav frame)


VELOCITY_MANIFOLD = mf.make_manifold(
    mf.Field("velocity", "vec", 3),
    mf.Field("z_position", "vec", 1),
)  # DOF = 4 → 9 sigma points


class VelocityUKFParams(NamedTuple):
    """Vehicle model and process noise; ``process_noise`` is the reference
    ctor's velocity diagonal 1e-4, z_position 0 (``VelocityUKF.cpp:54-55``)."""

    model: dyn.UWVParameters
    process_noise: torch.Tensor  # (4, 4)


class VelocityUKFState(NamedTuple):
    mu: VelocityState
    cov: torch.Tensor  # (4, 4)
    body_efforts: torch.Tensor  # (6,) latest thruster efforts (input cache)
    angular_velocity: torch.Tensor  # (3,) latest gyro rates (input cache)
    model_state: dyn.PoseVelocityState  # the ``motion_model`` orientation tracker


def default_process_noise(dtype=torch.float64, device=None) -> torch.Tensor:
    """The reference's process noise: 1e-4 on the three velocities, 0 on the
    yaw rate. ``device=None`` builds on the card (``utils/device.py``)."""
    device = resolve_device(device)
    q = torch.zeros((4, 4), dtype=dtype, device=device)
    q[:3, :3] = 1e-4 * torch.eye(3, dtype=dtype, device=device)
    return q


def initial_filter_state(initial_state: VelocityState, state_cov) -> VelocityUKFState:
    """The reference ctor's filter state (``VelocityUKF.cpp:49-56``): the
    tracker at the origin with identity orientation and the filter's
    velocity, input caches zero. Built on ``initial_state``'s device."""
    v = initial_state.velocity
    dtype, dev = v.dtype, v.device
    zeros = lambda n: torch.zeros(n, dtype=dtype, device=dev)
    return VelocityUKFState(
        mu=initial_state,
        cov=torch.as_tensor(state_cov, device=dev).to(dtype),
        body_efforts=zeros(6),
        angular_velocity=zeros(3),
        model_state=dyn.PoseVelocityState(
            position=zeros(3), orientation=mf.quat_identity(dtype, dev),
            linear_velocity=v, angular_velocity=zeros(3),
        ),
    )


def init(initial_state: VelocityState, state_cov, model: dyn.UWVParameters):
    """Filter state and parameters — the reference ctor with
    ``setupMotionModel`` (``VelocityUKF.cpp:49-77``)."""
    v = initial_state.velocity
    params = VelocityUKFParams(model=model, process_noise=default_process_noise(v.dtype, v.device))
    return initial_filter_state(initial_state, state_cov), params


def _trailing_scalars(model: dyn.UWVParameters) -> dyn.UWVParameters:
    """Weight and buoyancy with a trailing axis, so that a banked (B,) pair
    broadcasts against (…, B, 3) vectors as the shared scalars do."""
    return model._replace(weight=model.weight[..., None], buoyancy=model.buoyancy[..., None])


def _process_motion_model(chi: VelocityState, model, orientation, angular_velocity, body_efforts, dt):
    """``processMotionModel`` (``VelocityUKF.cpp:6-33``) of the (9, B)
    sigma points: seed the simulator with each point's velocity, take one
    dynamics step, and integrate depth with the rotated new velocity.
    ``model`` comes through :func:`_trailing_scalars`."""
    seed = dyn.PoseVelocityState(
        position=torch.zeros_like(chi.velocity), orientation=orientation,
        linear_velocity=chi.velocity, angular_velocity=angular_velocity,
    )
    new_velocity = dyn.simulate_effort(model, seed, body_efforts, dt, integrate_pose=False).linear_velocity
    z_vel = mf.quat_rotate(orientation, new_velocity)[..., 2:3]
    return VelocityState(velocity=new_velocity, z_position=chi.z_position + dt * z_vel)


def _predict_generic(bstate: VelocityUKFState, params: VelocityUKFParams, dt) -> VelocityUKFState:
    """``predictionStepImpl`` (``VelocityUKF.cpp:114-130``) of a bank: the
    sigma points through the dynamics with the tracker's orientation,
    Q = dt·process_noise (linear in dt, unlike PoseUKF's dt²), then one full
    kinematic step of the tracker with the same efforts."""
    if _params_banked(params):
        params = _broadcast_params_bank(params, bstate.cov.shape[0])
    model = _trailing_scalars(params.model)
    orientation = bstate.model_state.orientation

    def f(chi):
        return _process_motion_model(chi, model, orientation, bstate.angular_velocity, bstate.body_efforts, dt)

    mu, cov = ukf.predict(VELOCITY_MANIFOLD, bstate.mu, bstate.cov, f, dt * params.process_noise)
    tracker = dyn.simulate_effort(model, bstate.model_state, bstate.body_efforts, dt, integrate_pose=True)
    return bstate._replace(mu=mu, cov=cov, model_state=tracker)


def _update_generic(bstate, z, meas_cov, h):
    mu, cov, info = ukf.update(VELOCITY_MANIFOLD, bstate.mu, bstate.cov, z.to(bstate.cov.dtype), h, meas_cov)
    return bstate._replace(mu=mu, cov=cov), info


def _solo(fn, state: VelocityUKFState, *args):
    """Run a bank function on one filter (a bank of one)."""
    out = fn(tree_map(lambda a: a[None], state), *args)
    if isinstance(out, VelocityUKFState):
        return tree_map(lambda a: a[0], out)
    new_state, info = out
    return tree_map(lambda a: a[0], new_state), tree_map(lambda a: a[0], info)


def predict(state: VelocityUKFState, params: VelocityUKFParams, dt) -> VelocityUKFState:
    """Prediction of one filter (generic path)."""
    return _solo(_predict_generic, state, params, dt)


def update_dvl(state: VelocityUKFState, z, cov):
    """DVL velocity update of one filter — direct observation of the
    velocity (``measurementDVL``, ``VelocityUKF.cpp:35-40,79-85``)."""
    return _solo(lambda s: _update_generic(s, z[None], cov, lambda x: x.velocity), state)


def update_pressure(state: VelocityUKFState, z, cov):
    """Pressure-derived depth update of one filter — observes z_position
    (``measurementPressureSensor``, ``VelocityUKF.cpp:42-47,106-112``)."""
    return _solo(lambda s: _update_generic(s, z[None], cov, lambda x: x.z_position), state)


# ---------------------------------------------------------------------------
# bank entry points: K6 for a bank on the card with shared parameters
# ---------------------------------------------------------------------------


def _params_banked(params: VelocityUKFParams) -> bool:
    """True when a parameter leaf carries a bank axis (a Monte-Carlo sweep):
    the vehicle model's matrices count, not only the process noise."""
    m = params.model
    return (params.process_noise.ndim == 3 or m.inertia_matrix.ndim == 3 or m.damping_linear.ndim == 3
            or m.damping_quadratic.ndim == 3 or m.weight.ndim == 1 or m.buoyancy.ndim == 1
            or m.cog.ndim == 2 or m.cob.ndim == 2)


def _broadcast_params_bank(params: VelocityUKFParams, nb: int) -> VelocityUKFParams:
    """Give every parameter leaf a bank axis, so a sweep that banks only some
    leaves (e.g. the vehicle model but not the process noise) runs as one."""

    def b(leaf, unbanked_ndim):
        return leaf.expand(nb, *leaf.shape) if leaf.ndim == unbanked_ndim else leaf

    m = params.model
    model = m._replace(
        inertia_matrix=b(m.inertia_matrix, 2), damping_linear=b(m.damping_linear, 2),
        damping_quadratic=b(m.damping_quadratic, 2), weight=b(m.weight, 0), buoyancy=b(m.buoyancy, 0),
        cog=b(m.cog, 1), cob=b(m.cob, 1),
    )
    return params._replace(model=model, process_noise=b(params.process_noise, 2))


def _fused_route(bstate: VelocityUKFState) -> bool:
    """True for a bank on the card (K6), False for a CPU bank (generic
    path); any other device raises."""
    kind = bstate.cov.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no VelocityUKF bank path for device {bstate.cov.device}")
    return kind == "cuda" and bstate.cov.ndim == 3


def predict_bank(bstate: VelocityUKFState, params: VelocityUKFParams, dt) -> VelocityUKFState:
    """Bank prediction: one K6 launch for a bank on the card with one shared
    parameter set (sigma points and tracker through the dynamics); the
    generic batched path for a CPU bank or a banked parameter sweep."""
    if _fused_route(bstate) and not _params_banked(params):
        from . import velocity_fused

        return velocity_fused.predict_fused_banked(bstate, params, dt)
    return _predict_generic(bstate, params, dt)


def _update_bank(model, h, bstate, z, meas_cov):
    if _fused_route(bstate):
        from . import velocity_fused

        return velocity_fused.update_model_fused_banked(model, bstate, z, meas_cov)
    return _update_generic(bstate, z, meas_cov, h)


def update_dvl_bank(bstate, z, meas_cov):
    """Bank DVL update (``src/VelocityUKF.cpp:79-85``); one K6 launch on the
    card."""
    return _update_bank("dvl", lambda x: x.velocity, bstate, z, meas_cov)


def update_pressure_bank(bstate, z, meas_cov):
    """Bank pressure → depth update (``src/VelocityUKF.cpp:106-112``)."""
    return _update_bank("pressure", lambda x: x.z_position, bstate, z, meas_cov)


def integrate_gyro(state: VelocityUKFState, rates) -> VelocityUKFState:
    """Gyro rates are an input (``VelocityUKF.cpp:87-98``): cache them and
    refresh the tracker's angular velocity."""
    return state._replace(angular_velocity=rates, model_state=state.model_state._replace(angular_velocity=rates))


def integrate_body_efforts(state: VelocityUKFState, efforts) -> VelocityUKFState:
    """Thruster efforts are an input (``VelocityUKF.cpp:100-104``)."""
    return state._replace(body_efforts=efforts)


# ---------------------------------------------------------------------------
# the reference's class surface (one filter)
# ---------------------------------------------------------------------------


class VelocityUKF:
    """Stateful wrapper with the reference's class surface
    (``VelocityUKF.hpp:33-68``): construct, ``setup_motion_model``, the
    ``integrate_*`` overloads, ``prediction_step``. The math is the
    functions above."""

    def __init__(self, initial_state: VelocityState, state_cov):
        # live from construction (VelocityUKF.cpp:49-56); only the
        # prediction needs the motion model
        self.state: VelocityUKFState = initial_filter_state(initial_state, state_cov)
        self.params: Optional[VelocityUKFParams] = None

    def setup_motion_model(self, model: dyn.UWVParameters) -> bool:
        """Set or swap the vehicle model (``VelocityUKF.cpp:58-77``); keeps
        the estimate and the input caches and re-seeds the tracker's
        velocity from the current mean."""
        v = self.state.mu.velocity
        self.params = VelocityUKFParams(model=model, process_noise=default_process_noise(v.dtype, v.device))
        self.state = self.state._replace(model_state=self.state.model_state._replace(linear_velocity=v))
        return True

    def _require_model(self):
        # the reference's runtime error (VelocityUKF.cpp:117-118)
        if self.params is None:
            raise RuntimeError("Motion model is not initialized!")

    def _tensor(self, x):
        return torch.as_tensor(x, device=self.state.cov.device).to(self.state.cov.dtype)

    def prediction_step(self, dt: float) -> None:
        self._require_model()
        self.state = predict(self.state, self.params, dt)

    def set_process_noise_covariance(self, q) -> None:
        """Raw-Q setter of the filter base class (``src/VelocityUKF.cpp:54-56``)."""
        self._require_model()
        self.params = self.params._replace(process_noise=self._tensor(q))

    def integrate_dvl_measurement(self, mu, cov) -> ukf.UpdateInfo:
        check_measurement(mu, cov)
        self.state, info = update_dvl(self.state, self._tensor(mu), self._tensor(cov))
        return info

    def integrate_pressure_measurement(self, mu, cov) -> ukf.UpdateInfo:
        check_measurement(mu, cov)
        self.state, info = update_pressure(self.state, self._tensor(mu), self._tensor(cov))
        return info

    def integrate_gyro_measurement(self, mu, cov=None) -> None:
        if cov is not None:
            check_measurement(mu, cov)
        self.state = integrate_gyro(self.state, self._tensor(mu))

    def integrate_body_efforts(self, mu, cov=None) -> None:
        if cov is not None:
            check_measurement(mu, cov)
        self.state = integrate_body_efforts(self.state, self._tensor(mu))

    @property
    def mu(self) -> VelocityState:
        return self.state.mu

    @property
    def sigma(self) -> torch.Tensor:
        return self.state.cov

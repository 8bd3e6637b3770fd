"""Fossen 6-DOF AUV inverse dynamics — the counterpart of
``slam_uwv_kalman_filters_tpu/ops/dynamics.py`` (the ``uwv_dynamic_model``
layer the reference links against): the inverse dynamics of the PoseUKF's
model-aided effort measurement,

  τ = M·ν̇ + C(ν)ν + D_lin·ν + D_quad·(|ν|∘ν) + g(q),

and the forward simulator of the VelocityUKF (``ModelSimulation::sendEffort``):
ν̇ = M⁻¹(τ − C(ν)ν − D(ν)ν − g(q)), one explicit-Euler step of the velocity
and, optionally, the semi-implicit kinematic step of the pose
(:class:`PoseVelocityState`).

Frames: body-fixed 6-DOF ν = [v; ω], NWU navigation frame (z up). Every
function broadcasts over leading batch axes: ν is ``(..., 6)``, q
``(..., 4)`` and the 6×6 matrices ``(..., 6, 6)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.device import resolve_device
from .linalg_small import solve_spd
from .manifolds import _cross, quat_rotate, quat_rotate_inv, so3_boxplus

__all__ = [
    "UWVParameters",
    "PoseVelocityState",
    "default_uwv_parameters",
    "coriolis_effort",
    "damping_effort",
    "gravity_buoyancy_effort",
    "calc_efforts",
    "calc_acceleration",
    "simulate_effort",
    "embed_xy_yaw",
    "extract_xy_yaw",
]


class UWVParameters(NamedTuple):
    """Hydrodynamic parameters; inertia_matrix includes added mass."""

    inertia_matrix: torch.Tensor  # (6,6)
    damping_linear: torch.Tensor  # (6,6)
    damping_quadratic: torch.Tensor  # (6,6)
    weight: torch.Tensor  # scalar: m·g [N]
    buoyancy: torch.Tensor  # scalar [N]
    cog: torch.Tensor  # (3,) centre of gravity in body frame [m]
    cob: torch.Tensor  # (3,) centre of buoyancy in body frame [m]


class PoseVelocityState(NamedTuple):
    """The simulator state ``uwv_dynamic_model::PoseVelocityState``: position
    [nav], orientation quaternion [w, x, y, z] (body → nav), linear and
    angular velocity [body]."""

    position: torch.Tensor  # (..., 3)
    orientation: torch.Tensor  # (..., 4)
    linear_velocity: torch.Tensor  # (..., 3)
    angular_velocity: torch.Tensor  # (..., 3)


def default_uwv_parameters(dtype=torch.float64, device=None) -> UWVParameters:
    """Neutral test vehicle: diagonal inertia incl. added mass, light
    damping, neutrally buoyant with coincident COG/COB."""
    device = resolve_device(device)
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)
    return UWVParameters(
        inertia_matrix=torch.diag(t([120.0, 150.0, 180.0, 20.0, 30.0, 35.0])),
        damping_linear=torch.diag(t([40.0, 65.0, 80.0, 10.0, 12.0, 14.0])),
        damping_quadratic=torch.diag(t([25.0, 40.0, 50.0, 5.0, 6.0, 7.0])),
        weight=t(980.7),
        buoyancy=t(980.7),
        cog=torch.zeros(3, dtype=dtype, device=device),
        cob=torch.zeros(3, dtype=dtype, device=device),
    )


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (m @ v[..., None])[..., 0]


def coriolis_effort(inertia_matrix: torch.Tensor, velocity: torch.Tensor) -> torch.Tensor:
    """C(ν)ν = [ω × p1; ω × p2 + v × p1] with p1 = M₁·ν, p2 = M₂·ν."""
    v, w = velocity[..., :3], velocity[..., 3:]
    p1 = _mv(inertia_matrix[..., :3, :], velocity)
    p2 = _mv(inertia_matrix[..., 3:, :], velocity)
    return torch.cat([_cross(w, p1), _cross(w, p2) + _cross(v, p1)], dim=-1)


def damping_effort(params: UWVParameters, velocity: torch.Tensor) -> torch.Tensor:
    """D_lin·ν + D_quad·(|ν|∘ν)."""
    return _mv(params.damping_linear, velocity) + _mv(
        params.damping_quadratic, torch.abs(velocity) * velocity
    )


def gravity_buoyancy_effort(params: UWVParameters, orientation: torch.Tensor) -> torch.Tensor:
    """Restoring term g(q) in the body frame: −[R⁻¹(0,0,B−W);
    r_g × R⁻¹(0,0,−W) + r_b × R⁻¹(0,0,B)]."""
    up = torch.tensor([0.0, 0.0, 1.0], dtype=orientation.dtype, device=orientation.device)
    up_body = quat_rotate_inv(orientation, up)
    f_ext = up_body * (params.buoyancy - params.weight)
    f_grav = -up_body * params.weight
    f_buoy = up_body * params.buoyancy
    tau_ext = _cross(params.cog, f_grav) + _cross(params.cob, f_buoy)
    return -torch.cat([f_ext, tau_ext], dim=-1)


def calc_efforts(params: UWVParameters, acceleration, velocity, orientation) -> torch.Tensor:
    """Inverse dynamics: expected body efforts τ for a given motion
    (``DynamicModel::calcEfforts``)."""
    return (
        _mv(params.inertia_matrix, acceleration)
        + coriolis_effort(params.inertia_matrix, velocity)
        + damping_effort(params, velocity)
        + gravity_buoyancy_effort(params, orientation)
    )


def calc_acceleration(params: UWVParameters, efforts, velocity, orientation) -> torch.Tensor:
    """Forward dynamics ν̇ = M⁻¹(τ − C(ν)ν − D(ν)ν − g(q)), the exact inverse
    of :func:`calc_efforts`. M = M_RB + M_A is SPD, so the 6×6 solve is the
    unrolled Cholesky of ``linalg_small.solve_spd``."""
    rhs = (
        efforts
        - coriolis_effort(params.inertia_matrix, velocity)
        - damping_effort(params, velocity)
        - gravity_buoyancy_effort(params, orientation)
    )
    return solve_spd(params.inertia_matrix, rhs[..., None])[..., 0]


def simulate_effort(params: UWVParameters, state: PoseVelocityState, efforts, dt, *,
                    integrate_pose: bool = True) -> PoseVelocityState:
    """One Euler step of the forward simulator (``ModelSimulation::
    sendEffort``, order 1): the 6-DOF velocity by explicit Euler, then, with
    ``integrate_pose``, the position by the rotated *new* linear velocity and
    the orientation by the new angular velocity (semi-implicit Euler);
    without it the pose is kept, as the reference's velocity-only mode."""
    lin, ang = state.linear_velocity, state.angular_velocity
    shape = torch.broadcast_shapes(lin.shape, ang.shape)
    vel6 = torch.cat([lin.expand(shape), ang.expand(shape)], dim=-1)
    acc6 = calc_acceleration(params, efforts, vel6, state.orientation)
    lin_vel = lin + dt * acc6[..., :3]
    ang_vel = ang + dt * acc6[..., 3:]
    if integrate_pose:
        position = state.position + dt * quat_rotate(state.orientation, lin_vel)
        orientation = so3_boxplus(state.orientation, ang_vel, dt)
    else:
        position, orientation = state.position, state.orientation
    return PoseVelocityState(position, orientation, lin_vel, ang_vel)


_XY_YAW = torch.tensor([0, 1, 5])


def extract_xy_yaw(mat6: torch.Tensor) -> torch.Tensor:
    """(..., 6, 6) → (..., 3, 3) surge/sway/yaw block."""
    return mat6[..., _XY_YAW[:, None], _XY_YAW[None, :]]


def embed_xy_yaw(mat6: torch.Tensor, block3: torch.Tensor) -> torch.Tensor:
    """Write (..., 3, 3) (x, y, ψ) blocks into copies of a 6×6 matrix — the
    per-sigma-point parameter substitution of the effort measurement."""
    batch = torch.broadcast_shapes(mat6.shape[:-2], block3.shape[:-2])
    out = mat6.expand(*batch, 6, 6).clone()
    out[..., _XY_YAW[:, None], _XY_YAW[None, :]] = block3
    return out

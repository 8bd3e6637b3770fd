"""BottomUKF — the seafloor distance and normal tracker; counterpart of
``slam_uwv_kalman_filters_tpu/models/bottom_ukf.py`` (reference
``BottomUKF.hpp`` / ``src/BottomUKF.cpp``).

A 3-DOF UKF over {distance ℝ¹, bottom normal on S²}: the distance to the
bottom plane and its unit normal. The vehicle's velocity is an input of the
prediction (``BottomUKF.cpp:69-72``); the updates are per-beam DVL ranges by
ray/plane intersection (``BottomUKF.cpp:18-30, 56-61``) and a direct
S²-valued normal observation (``BottomUKF.cpp:63-67``).

Bank functions take a leading bank axis on every state leaf. A bank on the
card with one shared process noise takes the whole-step kernel K7
(``models/bottom_fused.py``, float32 or float64); a CPU bank takes the
generic batched path, and so does a banked (B, 3, 3) process noise on any
device, as in the JAX package (its fused kernel takes one shared Q).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import manifolds as mf
from ..ops import ukf
from ..parallel.bank import tree_map
from ..utils.validation import check_measurement

__all__ = [
    "BottomState",
    "BOTTOM_MANIFOLD",
    "BottomUKFState",
    "BottomUKFParams",
    "init",
    "predict",
    "predict_bank",
    "update_range",
    "update_range_bank",
    "update_normal",
    "update_normal_bank",
    "set_velocity",
    "BottomUKF",
]


class BottomState(NamedTuple):
    """``MTK_BUILD_MANIFOLD(BottomState, …)`` of ``BottomUKF.hpp:18-21``."""

    distance: torch.Tensor  # (1,) positive distance to the bottom [m]
    normal: torch.Tensor  # (3,) unit normal of the bottom plane (S², 2 DOF)


BOTTOM_MANIFOLD = mf.make_manifold(
    mf.Field("distance", "vec", 1),
    mf.Field("normal", "s2"),
)  # DOF = 3 → 7 sigma points


class BottomUKFParams(NamedTuple):
    """``process_noise`` is the reference ctor's identity
    (``BottomUKF.cpp:45``), scaled every prediction by speed²·dt²."""

    process_noise: torch.Tensor  # (3, 3), or (B, 3, 3) for a sweep


class BottomUKFState(NamedTuple):
    mu: BottomState
    cov: torch.Tensor  # (3, 3)
    velocity: torch.Tensor  # (3,) vehicle velocity input (``setVelocity``)


def init(initial_state: BottomState, state_cov):
    """Filter state (velocity zero) and parameters, on ``initial_state``'s
    device and dtype."""
    n = initial_state.normal
    state = BottomUKFState(
        mu=initial_state,
        cov=torch.as_tensor(state_cov, device=n.device).to(n.dtype),
        velocity=torch.zeros(3, dtype=n.dtype, device=n.device),
    )
    return state, BottomUKFParams(process_noise=torch.eye(3, dtype=n.dtype, device=n.device))


def _predict_generic(bstate: BottomUKFState, params: BottomUKFParams, dt) -> BottomUKFState:
    """``predictionStepImpl`` (``BottomUKF.cpp:48-54``) of a bank: the
    distance decreases by v_z·dt; Q = (v_x² + v_y²)·dt²·process_noise."""
    v = bstate.velocity

    def f(chi: BottomState) -> BottomState:
        return chi._replace(distance=chi.distance + dt * (-v[..., 2:3]))

    speed2 = v[..., 0] ** 2 + v[..., 1] ** 2
    q = (speed2 * dt**2)[:, None, None] * params.process_noise
    mu, cov = ukf.predict(BOTTOM_MANIFOLD, bstate.mu, bstate.cov, f, q)
    return bstate._replace(mu=mu, cov=cov)


def _h_range(direction: torch.Tensor, origin: torch.Tensor):
    """``measurementDistance`` (``BottomUKF.cpp:18-30``): the range along the
    beam (origin, direction) to the plane through (0, 0, −d) with normal n;
    0 where the beam is parallel to the plane (a select, no division by 0)."""

    def h(chi: BottomState) -> torch.Tensor:
        n = chi.normal
        bottom = torch.cat([torch.zeros_like(chi.distance), torch.zeros_like(chi.distance), -chi.distance], -1)
        v = (direction * n).sum(-1)
        safe_v = torch.where(v == 0.0, torch.ones_like(v), v)
        expected = ((bottom - origin) * n).sum(-1) / safe_v
        return torch.where(v == 0.0, torch.zeros_like(expected), expected)[..., None]

    return h


def _update_range_generic(bstate, z, meas_cov, direction, origin):
    dtype = bstate.cov.dtype
    mu, cov, info = ukf.update(
        BOTTOM_MANIFOLD, bstate.mu, bstate.cov, z.to(dtype), _h_range(direction.to(dtype), origin.to(dtype)),
        meas_cov,
    )
    return bstate._replace(mu=mu, cov=cov), info


def _update_normal_generic(bstate, z, meas_cov):
    mu, cov, info = ukf.update(
        BOTTOM_MANIFOLD, bstate.mu, bstate.cov, z.to(bstate.cov.dtype), lambda chi: chi.normal, meas_cov,
        meas_manifold=mf.S2_MANIFOLD,
    )
    return bstate._replace(mu=mu, cov=cov), info


def _solo(fn, state: BottomUKFState, *args):
    """Run a bank function on one filter (a bank of one)."""
    out = fn(tree_map(lambda a: a[None], state), *args)
    if isinstance(out, BottomUKFState):
        return tree_map(lambda a: a[0], out)
    new_state, info = out
    return tree_map(lambda a: a[0], new_state), tree_map(lambda a: a[0], info)


def _as(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, device=like.device).to(like.dtype)


def predict(state: BottomUKFState, params: BottomUKFParams, dt) -> BottomUKFState:
    """Prediction of one filter (generic path)."""
    return _solo(_predict_generic, state, params, dt)


def update_range(state: BottomUKFState, z, meas_cov, unit_direction, origin):
    """Per-beam DVL range update of one filter: the expected range is where
    the beam (origin, unit_direction) meets the bottom plane."""
    c = state.cov
    z = _as(z, c).reshape(1, 1)
    return _solo(_update_range_generic, state, z, _as(meas_cov, c).reshape(1, 1), _as(unit_direction, c),
                 _as(origin, c))


def update_normal(state: BottomUKFState, z, meas_cov):
    """Direct bottom-normal observation of one filter: an S²-valued
    measurement (``BottomUKF.cpp:32-37, 63-67``)."""
    return _solo(_update_normal_generic, state, _as(z, state.cov)[None], _as(meas_cov, state.cov))


def set_velocity(state: BottomUKFState, velocity) -> BottomUKFState:
    """Velocity is an input to the next prediction (``BottomUKF.cpp:69-72``);
    works on one filter or a bank."""
    return state._replace(velocity=_as(velocity, state.velocity))


# ---------------------------------------------------------------------------
# bank entry points: K7 for a bank on the card with a shared process noise
# ---------------------------------------------------------------------------


def _fused_route(bstate: BottomUKFState) -> bool:
    """True for a bank on the card (K7), False for a CPU bank (generic
    path); any other device raises."""
    kind = bstate.cov.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no BottomUKF bank path for device {bstate.cov.device}")
    return kind == "cuda" and bstate.cov.ndim == 3


def predict_bank(bstate: BottomUKFState, params: BottomUKFParams, dt) -> BottomUKFState:
    """Bank prediction: one K7 launch for a bank on the card with a shared
    (3, 3) process noise; the generic batched path for a CPU bank and for a
    banked (B, 3, 3) process-noise sweep (the reference's semantics, as the
    JAX package routes it)."""
    if _fused_route(bstate) and params.process_noise.ndim == 2:
        from . import bottom_fused

        return bottom_fused.predict_fused_banked(bstate, params, dt)
    return _predict_generic(bstate, params, dt)


def update_range_bank(bstate, z, meas_cov, unit_direction, origin):
    """Bank per-beam range update; ``unit_direction``/``origin`` shared (3,)
    or per instance (B, 3), ``z`` (B, 1) or (B,). One K7 launch on the
    card."""
    if _fused_route(bstate):
        from . import bottom_fused

        return bottom_fused.update_model_fused_banked("range", bstate, z, meas_cov, unit_direction, origin)
    nb, c = bstate.cov.shape[0], bstate.cov
    z = _as(z, c).reshape(nb, 1)
    d, o = _as(unit_direction, c).expand(nb, 3), _as(origin, c).expand(nb, 3)
    return _update_range_generic(bstate, z, _as(meas_cov, c).reshape(-1, 1, 1), d, o)


def update_normal_bank(bstate, z, meas_cov):
    """Bank S²-valued normal observation, ``z`` (B, 3) unit vectors; one K7
    launch on the card."""
    if _fused_route(bstate):
        from . import bottom_fused

        return bottom_fused.update_model_fused_banked("normal", bstate, z, meas_cov)
    return _update_normal_generic(bstate, _as(z, bstate.cov), _as(meas_cov, bstate.cov))


# ---------------------------------------------------------------------------
# the reference's class surface (one filter)
# ---------------------------------------------------------------------------


class BottomUKF:
    """Stateful wrapper with the reference's class surface
    (``BottomUKF.hpp:27-52``); the math is the functions above."""

    def __init__(self, initial_state: BottomState, state_cov):
        self.state, self.params = init(initial_state, state_cov)

    def prediction_step(self, dt: float) -> None:
        self.state = predict(self.state, self.params, dt)

    def set_process_noise_covariance(self, q) -> None:
        """Raw-Q setter of the filter base class (``setProcessNoiseCovariance``)."""
        self.params = self.params._replace(process_noise=_as(q, self.state.cov))

    def integrate_range_measurement(self, mu, cov, unit_direction, origin) -> ukf.UpdateInfo:
        check_measurement(mu, cov)
        self.state, info = update_range(self.state, mu, cov, unit_direction, origin)
        return info

    def integrate_normal_measurement(self, mu, cov) -> ukf.UpdateInfo:
        self.state, info = update_normal(self.state, mu, cov)
        return info

    def set_velocity(self, velocity) -> None:
        self.state = set_velocity(self.state, velocity)

    @property
    def mu(self) -> BottomState:
        return self.state.mu

    @property
    def sigma(self) -> torch.Tensor:
        return self.state.cov

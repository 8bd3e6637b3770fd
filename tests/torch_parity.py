"""Shared inputs and comparisons of the PyTorch-port parity tests.

Inputs are made with a seeded ``numpy.random.Generator`` as numpy trees of
the JAX package's NamedTuples; the JAX side gets them as numpy arrays, the
port gets them through ``utils.convert.from_numpy``. Everything runs in
float64 on the CPU (tests/conftest.py enables JAX x64).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from slam_uwv_kalman_filters_tpu.models import pose_ukf as jpukf
from slam_uwv_kalman_filters_tpu.ops import dynamics as jdyn
from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config
from slam_uwv_kalman_filters_tpu_torch.utils.convert import from_numpy, to_numpy

DT = 0.01


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jx(tree):
    return jax.tree.map(jnp.asarray, tree)


def pt(tree):
    return from_numpy(tree, device="cpu")


def mission_init():
    """(state, params) of the bench's mission configuration, numpy leaves."""
    state, params = jpukf.init_from_pose(
        imu_in_nwu_pos=jnp.zeros(3),
        imu_in_nwu_pos_cov=jnp.eye(3) * 0.01,
        imu_in_nwu_rot=jnp.array([1.0, 0.0, 0.0, 0.0]),
        imu_in_nwu_rot_cov=jnp.eye(3) * 1e-4,
        config=default_pose_ukf_config(),
        model_parameters=jdyn.default_uwv_parameters(),
        imu_delta_t=DT,
    )
    return np_tree(state), np_tree(params)


def _quat_exp(v):
    th = np.linalg.norm(v, axis=-1, keepdims=True)
    return np.concatenate([np.cos(th / 2), np.sinc(th / (2 * np.pi)) * 0.5 * v], axis=-1)


def _quat_mul(q, p):
    qw, qx, qy, qz = np.moveaxis(q, -1, 0)
    pw, px, py, pz = np.moveaxis(p, -1, 0)
    return np.stack(
        [
            qw * pw - qx * px - qy * py - qz * pz,
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
        ],
        axis=-1,
    )


def random_spd(rng, n, batch, scale_diag=None):
    """(batch, n, n) SPD matrices with correlated entries: D·C·D with C a
    random correlation matrix and D the given standard deviations."""
    g = rng.normal(size=(batch, n, n))
    c = g @ np.swapaxes(g, -1, -2) / n + np.eye(n)
    s = np.sqrt(np.diagonal(c, axis1=-2, axis2=-1))
    c = c / (s[:, :, None] * s[:, None, :])
    d = np.ones(n) if scale_diag is None else scale_diag
    return d[None, :, None] * c * d[None, None, :]


def random_bank(rng, state, n, spread=1.0):
    """A bank of ``n`` perturbed mission states (numpy leaves, JAX types):
    means moved off the initial state, correlated covariances at the
    initial state's per-field scales."""
    mu = state.mu
    nrm = lambda s, *shape: rng.normal(0.0, s, (n, *shape))
    q = _quat_mul(np.broadcast_to(mu.orientation, (n, 4)), _quat_exp(nrm(0.3 * spread, 3)))
    new_mu = mu._replace(
        position=mu.position + nrm(1.0, 3),
        orientation=q / np.linalg.norm(q, axis=-1, keepdims=True),
        velocity=nrm(0.5, 3),
        acceleration=nrm(0.1, 3),
        bias_gyro=nrm(1e-5, 3),
        bias_acc=nrm(1e-3, 3),
        gravity=mu.gravity + nrm(0.01, 1),
        inertia=mu.inertia + nrm(1.0, 3, 3),
        lin_damping=mu.lin_damping + nrm(0.5, 3, 3),
        quad_damping=mu.quad_damping + nrm(0.5, 3, 3),
        water_velocity=nrm(0.1, 2),
        water_velocity_below=nrm(0.1, 2),
        bias_adcp=nrm(0.01, 2),
        water_density=mu.water_density + nrm(1.0, 1),
    )
    sd = np.sqrt(np.diag(state.cov)) * spread
    cov = random_spd(rng, 53, n, sd)
    return state._replace(mu=new_mu, cov=cov, rotation_rate=nrm(0.01, 3))


def assert_tree_close(port_tree, ref_tree, *, rtol, atol, what=""):
    """Field-by-field closeness of a port tree and a JAX tree."""
    _close_rec(to_numpy(port_tree), np_tree(ref_tree), rtol, atol, what)


def _close_rec(port, ref, rtol, atol, what):
    if hasattr(ref, "_fields"):
        for name in ref._fields:
            _close_rec(getattr(port, name), getattr(ref, name), rtol, atol, f"{what}.{name}")
        return
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol, err_msg=what)


def banked_params(rng, params, n):
    """A fully banked Monte-Carlo draw of ``params`` (numpy leaves, JAX
    types): every leaf gets the bank axis; process noise, water-velocity
    scale, atmospheric pressure and vehicle inertia are scaled per instance
    as in the JAX package's banked lanes test, and the Markov time constants,
    rest points and projection anchor move too, so every per-instance
    operand differs."""
    scales = 1.0 + 0.2 * rng.standard_normal(n).clip(-0.8, 0.8)
    draw = lambda *shape: 1.0 + 0.1 * rng.standard_normal((n, *shape)).clip(-2, 2)
    bp = jax.tree.map(lambda x: np.broadcast_to(x, (n, *np.shape(x))).copy(), params)
    return bp._replace(
        process_noise=bp.process_noise * scales[:, None, None],
        water_velocity_scale=bp.water_velocity_scale * scales,
        atmospheric_pressure=bp.atmospheric_pressure + rng.normal(scale=100.0, size=n),
        model=bp.model._replace(inertia_matrix=bp.model.inertia_matrix * scales[:, None, None]),
        gyro_bias_tau=bp.gyro_bias_tau * draw(),
        lin_damping_tau=bp.lin_damping_tau * draw(),
        inertia_offset=bp.inertia_offset * draw(3, 3),
        water_density_offset=bp.water_density_offset * draw(),
        projection=bp.projection._replace(lat0=bp.projection.lat0 + 0.01 * (draw() - 1.0)),
    )


def _leaf(v):
    if v is None or isinstance(v, (str, bool, int, float)):
        return v
    if isinstance(v, tuple):
        return tuple(_leaf(x) for x in v)
    return from_numpy(np.asarray(v), device="cpu")


def step_updates(updates, cls):
    """A JAX package StepUpdate list (pose or velocity) → the port's ``cls``
    StepUpdates: array fields to float64 CPU tensors, names, thresholds and
    Python scalars as they are."""
    return [cls(*(_leaf(v) for v in u)) for u in updates]

"""The bank that the fused-path tests of the JAX package (tests/test_pose_fused_*.py) build."""

import jax
import jax.numpy as jnp

from slam_uwv_kalman_filters_tpu.models import pose_ukf as pukf
from slam_uwv_kalman_filters_tpu.ops import dynamics as dyn, manifolds as mf
from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod
from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config


def make_bank(rng, n, dtype=jnp.float32):
    """A heterogeneous PoseUKF bank of ``n`` at ``dtype`` (positions, velocities,
    orientations and rotation rates drawn from ``rng``) and its parameters."""
    cfg = default_pose_ukf_config()
    model = dyn.default_uwv_parameters(dtype=dtype)
    state, params = pukf.init_from_pose(
        imu_in_nwu_pos=jnp.zeros(3, dtype),
        imu_in_nwu_pos_cov=jnp.eye(3, dtype=dtype) * 0.04,
        imu_in_nwu_rot=jnp.array([1.0, 0, 0, 0], dtype),
        imu_in_nwu_rot_cov=jnp.eye(3, dtype=dtype) * 1e-4,
        config=cfg,
        model_parameters=model,
        imu_delta_t=0.01,
        dtype=dtype,
    )
    bstate = bankmod.replicate(state, n)
    # heterogeneous bank: perturb position/velocity/orientation per instance
    mu = bstate.mu._replace(
        position=bstate.mu.position + jnp.asarray(rng.normal(scale=1.0, size=(n, 3)), dtype),
        velocity=bstate.mu.velocity + jnp.asarray(rng.normal(scale=0.3, size=(n, 3)), dtype),
        orientation=jax.vmap(lambda q, v: mf.so3_boxplus(q, v))(
            bstate.mu.orientation, jnp.asarray(rng.normal(scale=0.2, size=(n, 3)), dtype)
        ),
    )
    rr = jnp.asarray(rng.normal(scale=0.05, size=(n, 3)), dtype)
    return bstate._replace(mu=mu, rotation_rate=rr), params

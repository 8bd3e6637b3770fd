"""PoseUKF fused paths of the JAX package, in Pallas interpret mode on the CPU:
the fused prediction (K2 in interpret mode) against ``vmap(pose_ukf.predict)``: lane
padding, chains, large orientation spreads, banked parameters and odd banks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_uwv_kalman_filters_tpu.models import pose_fused, pose_ukf as pukf
from slam_uwv_kalman_filters_tpu.ops import dynamics as dyn
from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod
from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config

from pose_fused_bank import make_bank

RNG = np.random.default_rng(77)
_make_bank = functools.partial(make_bank, RNG)


def test_fused_predict_matches_generic():
    bstate, params = _make_bank(3)
    dt = 0.1
    ref = jax.vmap(lambda s: pukf.predict(s, params, dt))(bstate)
    out = pose_fused.predict_fused_banked(bstate, params, dt, interpret=True)

    np.testing.assert_allclose(np.asarray(out.cov), np.asarray(ref.cov), rtol=2e-4, atol=3e-6)
    for name in pukf.PoseState._fields:
        a, b = np.asarray(getattr(out.mu, name)), np.asarray(getattr(ref.mu, name))
        if name == "orientation":  # compare up to quaternion sign
            b = np.where(np.sum(a * b, axis=-1, keepdims=True) < 0, -b, b)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-5, err_msg=name)
    # exact symmetry by construction (generic path needs an explicit symmetrize)
    c = np.asarray(out.cov)
    np.testing.assert_array_equal(c, np.swapaxes(c, -1, -2))


def test_fused_predict_pads_nonlane_bank():
    bstate, params = _make_bank(2)
    out = pose_fused.predict_fused_banked(bstate, params, 0.05, interpret=True)
    ref = jax.vmap(lambda s: pukf.predict(s, params, 0.05))(bstate)
    assert out.cov.shape == (2, 53, 53)
    np.testing.assert_allclose(np.asarray(out.cov), np.asarray(ref.cov), rtol=2e-4, atol=3e-6)


@pytest.mark.slow
@pytest.mark.time_limit(240)
def test_fused_predict_chain_stays_consistent():
    """Several chained fused steps track the generic path (error growth is
    bounded by f32 roundoff, not systematic divergence)."""
    bstate, params = _make_bank(2)
    a, b = bstate, bstate
    for _ in range(5):
        a = pose_fused.predict_fused_banked(a, params, 0.02, interpret=True)
        b = jax.vmap(lambda s: pukf.predict(s, params, 0.02))(b)
    np.testing.assert_allclose(np.asarray(a.mu.position), np.asarray(b.mu.position), atol=1e-4)
    np.testing.assert_allclose(np.asarray(a.cov), np.asarray(b.cov), rtol=1e-3, atol=1e-5)


def test_fused_predict_large_orientation_spread():
    """Near-unknown heading (60° 1σ): the fixed-iteration fused mean must
    still match the tolerance-driven generic mean (the ±symmetric sigma set
    converges in ~2 Karcher iterations regardless of spread)."""
    import math

    cfg = default_pose_ukf_config()
    model = dyn.default_uwv_parameters(dtype=jnp.float32)
    state, params = pukf.init_from_pose(
        imu_in_nwu_pos=jnp.zeros(3, jnp.float32),
        imu_in_nwu_pos_cov=jnp.eye(3, dtype=jnp.float32) * 0.04,
        imu_in_nwu_rot=jnp.array([1.0, 0, 0, 0], jnp.float32),
        imu_in_nwu_rot_cov=jnp.eye(3, dtype=jnp.float32) * math.radians(60.0) ** 2,
        config=cfg,
        model_parameters=model,
        imu_delta_t=0.01,
        dtype=jnp.float32,
    )
    bstate = bankmod.replicate(state, 2)
    bstate = bstate._replace(rotation_rate=jnp.zeros((2, 3), jnp.float32))
    ref = jax.vmap(lambda s: pukf.predict(s, params, 0.1))(bstate)
    out = pose_fused.predict_fused_banked(bstate, params, 0.1, interpret=True)
    a, b = np.asarray(out.mu.orientation[0]), np.asarray(ref.mu.orientation[0])
    b = b if np.dot(a, b) >= 0 else -b
    np.testing.assert_allclose(a, b, atol=3e-6)
    np.testing.assert_allclose(np.asarray(out.cov), np.asarray(ref.cov), rtol=1e-3, atol=1e-5)


def test_fused_predict_banked_params_matches_generic():
    """Monte-Carlo parameter banks through the fused kernel: per-instance
    taus/offsets/process noise must match vmap(predict) over (state, params)."""
    bstate, params = _make_bank(3)
    n = 3
    # per-instance parameter bank: perturb taus, offsets and Q per instance
    scales = jnp.asarray([0.5, 1.0, 2.0], jnp.float32)
    params_bank = jax.vmap(
        lambda s: params._replace(
            process_noise=params.process_noise * s,
            gyro_bias_tau=params.gyro_bias_tau * s,
            water_velocity_tau=params.water_velocity_tau / s,
            gyro_bias_offset=params.gyro_bias_offset + (s - 1.0) * 1e-4,
            water_velocity_scale=params.water_velocity_scale * s,
        )
    )(scales)

    ref = jax.vmap(lambda st, pr: pukf.predict(st, pr, 0.05))(bstate, params_bank)
    out = pose_fused.predict_fused_banked(bstate, params_bank, 0.05, interpret=True)
    np.testing.assert_allclose(np.asarray(out.cov), np.asarray(ref.cov), rtol=5e-3, atol=3e-6)
    for name in ("position", "velocity", "bias_gyro", "water_velocity"):
        np.testing.assert_allclose(
            np.asarray(getattr(out.mu, name)),
            np.asarray(getattr(ref.mu, name)),
            rtol=1e-4,
            atol=2e-5,
            err_msg=name,
        )


def test_fused_predict_odd_bank_sizes():
    """Lane padding correctness for a non-multiple-of-128 bank (nb=1,
    pad=127), with distinct per-instance states so a padding mix-up would
    show. Grid>1 + padding (nb 127/129/500) is verified on the real chip —
    interpret mode at those sizes costs ~a minute of suite time for no extra
    logic coverage."""
    for nb in (1,):
        bstate, params = _make_bank(2)
        one = jax.tree_util.tree_map(lambda a: a[0], bstate)
        bs = jax.tree_util.tree_map(lambda a: jnp.tile(a[None], (nb, *(1,) * a.ndim)), one)
        bs = bs._replace(
            mu=bs.mu._replace(
                velocity=jnp.arange(nb * 3, dtype=jnp.float32).reshape(nb, 3) * 1e-3
            )
        )
        out = pose_fused.predict_fused_banked(bs, params, 0.02, interpret=True)
        ref = jax.vmap(lambda s: pukf.predict(s, params, 0.02))(bs)
        np.testing.assert_allclose(np.asarray(out.cov), np.asarray(ref.cov), atol=2e-6)
        np.testing.assert_allclose(
            np.asarray(out.mu.velocity), np.asarray(ref.mu.velocity), atol=1e-6
        )


"""PoseUKF fused paths of the JAX package, in Pallas interpret mode on the CPU:
kernel-layout chains and whole steps (``predict_lanes`` → updates, ``step_lanes``)
against the banked chain: the parity fuzz, the multi-sensor step, its input checks and a
mission second.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_uwv_kalman_filters_tpu.models import pose_fused, pose_ukf as pukf
from slam_uwv_kalman_filters_tpu.ops import manifolds as mf

from pose_fused_bank import make_bank

RNG = np.random.default_rng(77)
_make_bank = functools.partial(make_bank, RNG)


@pytest.mark.time_limit(240)
def test_lanes_chain_matches_banked_path():
    """to_lanes → predict_lanes → update_lanes → from_lanes equals the
    bank-first fused sequence (same kernels, conversions only at the ends)."""
    from slam_uwv_kalman_filters_tpu.models import pose_update_fused as puf

    bstate, params = _make_bank(2)
    z = jnp.asarray(RNG.normal(scale=0.3, size=(2, 3)), jnp.float32)
    r = jnp.eye(3, dtype=jnp.float32) * 1e-3
    h = lambda s: mf.quat_rotate_inv(s.orientation, s.velocity)
    deps = ("orientation", "velocity")

    # reference: bank-first fused path
    ref = pose_fused.predict_fused_banked(bstate, params, 0.05, interpret=True)
    ref, ref_info = puf.update_fused_banked(ref, params, z, r, h, deps, None, interpret=True)

    # lanes path: one conversion in, one out
    ls = pose_fused.to_lanes(bstate)
    ls = pose_fused.predict_lanes(ls, params, 0.05, interpret=True)
    ls, info = puf.update_lanes(ls, params, z, r, h, deps, None, interpret=True)
    out = pose_fused.from_lanes(ls, bstate)

    np.testing.assert_allclose(np.asarray(out.cov), np.asarray(ref.cov), atol=2e-6)
    np.testing.assert_allclose(
        np.asarray(out.mu.position), np.asarray(ref.mu.position), atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(info.mahalanobis2), np.asarray(ref_info.mahalanobis2), rtol=1e-5
    )
    # rotation-rate caching round-trips through the lanes layout
    rr = jnp.asarray(RNG.normal(scale=0.01, size=(2, 3)), jnp.float32)
    ls2 = pose_fused.set_rotation_rate_lanes(ls, rr)
    out2 = pose_fused.from_lanes(ls2, bstate)
    np.testing.assert_allclose(np.asarray(out2.rotation_rate), np.asarray(rr), atol=0)


@pytest.mark.slow
@pytest.mark.time_limit(480)
def test_fused_parity_fuzz_random_states_and_dt():
    """Randomized parity: random bank states (positions to ±1 km, velocities
    to ±3 m/s, strong rotations, perturbed damping/current/bias states) and
    random dt ∈ [1e-3, 0.5] must track the generic path through a
    predict + gated-update chain."""
    for trial in range(4):
        rng = np.random.default_rng(1000 + trial)
        bstate, params = _make_bank(2)
        n = 2
        mu = bstate.mu._replace(
            position=jnp.asarray(rng.normal(scale=300.0, size=(n, 3)), jnp.float32),
            velocity=jnp.asarray(rng.normal(scale=1.5, size=(n, 3)), jnp.float32),
            acceleration=jnp.asarray(rng.normal(scale=0.5, size=(n, 3)), jnp.float32),
            orientation=jax.vmap(mf.so3_boxplus)(
                bstate.mu.orientation, jnp.asarray(rng.normal(scale=1.0, size=(n, 3)), jnp.float32)
            ),
            bias_gyro=jnp.asarray(rng.normal(scale=1e-3, size=(n, 3)), jnp.float32),
            water_velocity=jnp.asarray(rng.normal(scale=0.2, size=(n, 2)), jnp.float32),
            water_density=jnp.asarray(1025.0 + rng.normal(scale=5.0, size=(n, 1)), jnp.float32),
        )
        bstate = bstate._replace(
            mu=mu, rotation_rate=jnp.asarray(rng.normal(scale=0.1, size=(n, 3)), jnp.float32)
        )
        dt = float(10 ** rng.uniform(-3, np.log10(0.5)))

        ref = jax.vmap(lambda s: pukf.predict(s, params, dt))(bstate)
        out = pose_fused.predict_fused_banked(bstate, params, dt, interpret=True)
        np.testing.assert_allclose(
            np.asarray(out.cov), np.asarray(ref.cov), rtol=5e-3, atol=2e-5,
            err_msg=f"trial {trial} dt={dt:.4f}",
        )
        np.testing.assert_allclose(
            np.asarray(out.mu.position), np.asarray(ref.mu.position), rtol=1e-5, atol=1e-3,
            err_msg=f"trial {trial}",
        )

        z = jnp.asarray(rng.normal(scale=1.0, size=(n, 2)), jnp.float32)
        r = jnp.eye(2, dtype=jnp.float32) * 1e-2
        out2, info = pukf.update_xy_position_bank(
            out, params, out.mu.position[:, :2] + z * 0.01, r, gate_threshold=5.991,
            use_fused=False,
        )
        from slam_uwv_kalman_filters_tpu.models import pose_update_fused as puf

        out3, info3 = puf.update_fused_banked(
            out, params, out.mu.position[:, :2] + z * 0.01, r,
            lambda s: s.position[:2], ("position",), 5.991, interpret=True,
        )
        np.testing.assert_allclose(
            np.asarray(out3.cov), np.asarray(out2.cov), rtol=5e-3, atol=2e-5,
            err_msg=f"trial {trial} update",
        )
        np.testing.assert_array_equal(
            np.asarray(info3.accepted), np.asarray(info.accepted), err_msg=f"trial {trial} gate"
        )
        # the in-kernel model route must agree with both on the same fuzz state
        out4, info4 = puf.update_model_fused_banked(
            "xy_position", out, out.mu.position[:, :2] + z * 0.01, r, 5.991,
            interpret=True,
        )
        np.testing.assert_allclose(
            np.asarray(out4.cov), np.asarray(out2.cov), rtol=5e-3, atol=2e-5,
            err_msg=f"trial {trial} in-kernel model",
        )
        np.testing.assert_array_equal(
            np.asarray(info4.accepted), np.asarray(info.accepted),
            err_msg=f"trial {trial} in-kernel gate",
        )


@pytest.mark.time_limit(190)
def test_step_velocity_lanes_matches_two_launch_chain():
    """The single-launch whole step (predict + DVL update,
    step_velocity_lanes) is bit-identical to predict_lanes followed by
    update_velocity_lanes — same kernels composed in one launch."""
    from slam_uwv_kalman_filters_tpu.models import pose_update_fused as puf

    bstate, params = _make_bank(2)
    rv = jnp.asarray(RNG.normal(scale=0.3, size=(2, 3)), jnp.float32)
    bstate = bstate._replace(
        mu=bstate.mu._replace(
            orientation=jax.vmap(mf.quat_exp)(rv),
            velocity=jnp.asarray(RNG.normal(size=(2, 3)), jnp.float32),
        )
    )
    z = jnp.asarray(RNG.normal(scale=0.5, size=(2, 3)), jnp.float32)
    r = jnp.eye(3, dtype=jnp.float32) * 1e-3

    ls0 = pose_fused.to_lanes(bstate)
    a = pose_fused.predict_lanes(ls0, params, 0.05, interpret=True)
    a, ai = puf.update_velocity_lanes(a, params, z, r, None, interpret=True)
    b, bi = puf.step_velocity_lanes(ls0, params, 0.05, z, r, None, interpret=True)
    ao, bo = pose_fused.from_lanes(a, bstate), pose_fused.from_lanes(b, bstate)
    np.testing.assert_array_equal(np.asarray(bo.cov), np.asarray(ao.cov))
    np.testing.assert_array_equal(np.asarray(bo.mu.velocity), np.asarray(ao.mu.velocity))
    np.testing.assert_array_equal(
        np.asarray(bi.mahalanobis2), np.asarray(ai.mahalanobis2)
    )


@pytest.mark.slow
@pytest.mark.time_limit(470)
def test_step_lanes_multi_sensor_matches_chain():
    """The generalized single-launch step (predict + a chain of in-kernel
    updates, step_lanes) is bit-identical to predict_lanes followed by the
    matching update_model_lanes calls — same kernels composed in one launch,
    each update re-drawing sigma points from the then-current covariance.
    The chain covers all six shared-aux in-kernel models (body_efforts, the
    seventh FUSED_MODELS entry, needs per-instance aux and is not
    step-chainable — its parity test stands alone)."""
    from slam_uwv_kalman_filters_tpu.models import pose_update_fused as puf

    nb = 2
    bstate, params = _make_bank(nb)
    z_dvl = jnp.asarray(RNG.normal(scale=0.5, size=(nb, 3)), jnp.float32)
    r_dvl = jnp.eye(3, dtype=jnp.float32) * 1e-3
    z_p = jnp.asarray(RNG.normal(loc=101325.0, scale=2e4, size=(nb, 1)), jnp.float32)
    r_p = jnp.eye(1, dtype=jnp.float32) * 1e2
    z_xy = jnp.asarray(RNG.normal(scale=1.0, size=(nb, 2)), jnp.float32)
    r_xy = jnp.eye(2, dtype=jnp.float32) * 1e-2
    z_z = jnp.asarray(RNG.normal(scale=1.0, size=(nb, 1)), jnp.float32)
    r_z = jnp.eye(1, dtype=jnp.float32) * 1e-2
    z_acc = jnp.asarray(RNG.normal(scale=0.2, size=(nb, 3)), jnp.float32)
    r_acc = jnp.eye(3, dtype=jnp.float32) * 1e-2
    z_wv = jnp.asarray(RNG.normal(scale=0.1, size=(nb, 2)), jnp.float32)
    r_wv = jnp.eye(2, dtype=jnp.float32) * 1e-2
    p_aux = (params.atmospheric_pressure, 0.0, 0.0, 0.0)
    cw = 0.3  # ADCP cell weighting

    ls0 = pose_fused.to_lanes(bstate)
    a = pose_fused.predict_lanes(ls0, params, 0.05, interpret=True)
    a, ai0 = puf.update_model_lanes("velocity", a, z_dvl, r_dvl, None, interpret=True)
    a, ai1 = puf.update_model_lanes("pressure", a, z_p, r_p, None, p_aux, interpret=True)
    a, ai2 = puf.update_model_lanes("xy_position", a, z_xy, r_xy, 5.991, interpret=True)
    a, ai3 = puf.update_model_lanes("z_position", a, z_z, r_z, None, interpret=True)
    a, ai4 = puf.update_model_lanes("acceleration", a, z_acc, r_acc, None, interpret=True)
    a, ai5 = puf.update_model_lanes("water_velocity", a, z_wv, r_wv, 5.991, (cw,), interpret=True)

    b, infos = puf.step_lanes(
        ls0, params, 0.05,
        [
            puf.StepUpdate("velocity", z_dvl, r_dvl),
            puf.StepUpdate("pressure", z_p, r_p, aux=p_aux),
            puf.StepUpdate("xy_position", z_xy, r_xy, gate_threshold=5.991),
            puf.StepUpdate("z_position", z_z, r_z),
            puf.StepUpdate("acceleration", z_acc, r_acc),
            puf.StepUpdate("water_velocity", z_wv, r_wv, gate_threshold=5.991, aux=(cw,)),
        ],
        interpret=True,
    )
    assert len(infos) == 6
    ao, bo = pose_fused.from_lanes(a, bstate), pose_fused.from_lanes(b, bstate)
    np.testing.assert_array_equal(np.asarray(bo.cov), np.asarray(ao.cov))
    np.testing.assert_array_equal(np.asarray(bo.mu.position), np.asarray(ao.mu.position))
    np.testing.assert_array_equal(np.asarray(bo.mu.orientation), np.asarray(ao.mu.orientation))
    for got, want in zip(infos, (ai0, ai1, ai2, ai3, ai4, ai5)):
        np.testing.assert_array_equal(np.asarray(got.mahalanobis2), np.asarray(want.mahalanobis2))
        np.testing.assert_array_equal(np.asarray(got.accepted), np.asarray(want.accepted))
        np.testing.assert_array_equal(np.asarray(got.innovation), np.asarray(want.innovation))


def test_step_lanes_validates_inputs():
    from slam_uwv_kalman_filters_tpu.models import pose_update_fused as puf
    import pytest

    bstate, params = _make_bank(2)
    ls0 = pose_fused.to_lanes(bstate)
    with pytest.raises(ValueError, match="at least one"):
        puf.step_lanes(ls0, params, 0.05, [])
    z3 = jnp.zeros((3, 3), jnp.float32)  # bank of 3 into a bank-of-2 state
    z2 = jnp.zeros((2, 1), jnp.float32)
    with pytest.raises(ValueError, match="inconsistent bank"):
        puf.step_lanes(
            ls0, params, 0.05,
            [
                puf.StepUpdate("velocity", jnp.zeros((2, 3), jnp.float32), jnp.eye(3)),
                puf.StepUpdate("z_position", z3[:, :1], jnp.eye(1)),
            ],
        )


@pytest.mark.slow
@pytest.mark.time_limit(1400)
def test_mission_second_lanes_matches_bank_chain():
    """The lanes-persistent full-mission loop (bench.py pose_full default:
    predict + acc every tick, multi-rate DVL/pressure/ADCP/efforts) is
    bit-identical to the public fused bank chain — the layout conversions
    and the deferred lower-triangle mirror drop out of the math entirely."""
    from slam_uwv_kalman_filters_tpu.models import pose_update_fused as puf
    from slam_uwv_kalman_filters_tpu.ops import ukf as ukfops

    nb = 2
    bstate, params = _make_bank(nb)
    dt = 0.01
    acc = jnp.asarray(RNG.normal(scale=0.1, size=(nb, 3)) + [0, 0, 9.81], jnp.float32)
    r_acc = jnp.eye(3, dtype=jnp.float32) * 4e-5
    dvl = jnp.asarray(RNG.normal(scale=0.3, size=(nb, 3)), jnp.float32)
    r_dvl = jnp.eye(3, dtype=jnp.float32) * 1e-3
    press = jnp.full((nb, 1), 101325.0, jnp.float32)
    r_press = jnp.eye(1, dtype=jnp.float32) * 2500.0
    adcp = jnp.asarray(RNG.normal(scale=0.05, size=(nb, 2)), jnp.float32)
    r_adcp = jnp.eye(2, dtype=jnp.float32) * 1e-3
    eff = jnp.asarray(RNG.normal(scale=0.5, size=(nb, 6)), jnp.float32)
    r_eff = jnp.eye(6, dtype=jnp.float32) * 1.0
    p_atm = params.atmospheric_pressure

    # compressed 5-tick schedule: every stream fires at least once
    dvl_at = lambda k: k % 2 == 1
    press_at = lambda k: k == 4
    adcp_at = lambda k: k == 4
    eff_at = lambda k: k % 2 == 0

    # reference: public fused bank chain (mirrors + layout converts per call)
    ref = bstate
    for k in range(5):
        ref = pukf.predict_bank(ref, params, dt, use_fused="interpret")
        ref, _ = pukf.update_acceleration_bank(ref, params, acc, r_acc, use_fused="interpret")
        if dvl_at(k):
            ref, _ = pukf.update_velocity_bank(ref, params, dvl, r_dvl, use_fused="interpret")
        if press_at(k):
            ref, _ = pukf.update_pressure_bank(ref, params, press, r_press, use_fused="interpret")
        if adcp_at(k):
            ref, _ = pukf.update_water_velocity_bank(
                ref, params, adcp, r_adcp, 0.5, use_fused="interpret"
            )
        if eff_at(k):
            rr = pukf.get_rotation_rate_bank(ref, params)
            ref, _ = pukf.update_body_efforts_bank(
                ref, params, eff, r_eff, rr, use_fused="interpret"
            )

    # lanes-persistent loop: one conversion in, one out
    ls = pose_fused.to_lanes(bstate)
    for k in range(5):
        ls = pose_fused.predict_lanes(ls, params, dt, interpret=True)
        ls, _ = puf.update_model_lanes("acceleration", ls, acc, r_acc, interpret=True)
        if dvl_at(k):
            ls, _ = puf.update_velocity_lanes(ls, params, dvl, r_dvl, interpret=True)
        if press_at(k):
            ls, _ = puf.update_model_lanes(
                "pressure", ls, press, r_press, aux=(p_atm, 0.0, 0.0, 0.0), interpret=True
            )
        if adcp_at(k):
            ls, _ = puf.update_model_lanes(
                "water_velocity", ls, adcp, r_adcp, ukfops.D2P95, aux=(0.5,), interpret=True
            )
        if eff_at(k):
            ls, _ = puf.update_body_efforts_lanes(ls, params, eff, r_eff, interpret=True)
    out = pose_fused.from_lanes(ls, bstate)

    np.testing.assert_array_equal(np.asarray(out.cov), np.asarray(ref.cov))
    np.testing.assert_array_equal(np.asarray(out.mu.position), np.asarray(ref.mu.position))
    np.testing.assert_array_equal(
        np.asarray(out.mu.orientation), np.asarray(ref.mu.orientation)
    )
    np.testing.assert_array_equal(np.asarray(out.mu.bias_gyro), np.asarray(ref.mu.bias_gyro))


"""PoseUKF fused paths of the JAX package, in Pallas interpret mode on the CPU:
the fused update tails and in-kernel measurement models (``models/pose_update_fused.py``,
interpret mode) against the generic per-instance updates, and the bank dispatchers' parameter rules.
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


def test_fused_update_matches_generic():
    """Fused update tail (models/pose_update_fused.py, interpret mode) equals
    vmap(ukf.update) for the DVL velocity model, including the gate."""
    from slam_uwv_kalman_filters_tpu.models import pose_update_fused
    from slam_uwv_kalman_filters_tpu.ops import ukf

    bstate, params = _make_bank(3)
    n = 3
    z = jnp.asarray(RNG.normal(scale=0.3, size=(n, 3)), jnp.float32)
    r = jnp.eye(3, dtype=jnp.float32) * 1e-3
    h = lambda s: mf.quat_rotate_inv(s.orientation, s.velocity)

    out, info = pose_update_fused.update_fused_banked(
        bstate, params, z, r, h, ("orientation", "velocity"), None, interpret=True
    )
    ref_s, ref_info = pukf.update_velocity(
        jax.tree_util.tree_map(lambda a: a[0], bstate), params, z[0], r
    )
    np.testing.assert_allclose(np.asarray(out.cov[0]), np.asarray(ref_s.cov), rtol=5e-3, atol=2e-6)
    np.testing.assert_allclose(
        np.asarray(out.mu.velocity[0]), np.asarray(ref_s.mu.velocity), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        float(info.mahalanobis2[0]), float(ref_info.mahalanobis2), rtol=1e-3
    )
    # gate: absurd measurement must be rejected and leave the state untouched
    z_bad = jnp.full((n, 3), 1e4, jnp.float32)
    out2, info2 = pose_update_fused.update_fused_banked(
        bstate, params, z_bad, r, h, ("orientation", "velocity"), 5.991, interpret=True
    )
    assert not bool(info2.accepted[0])
    np.testing.assert_allclose(np.asarray(out2.cov), np.asarray(bstate.cov), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(out2.mu.position), np.asarray(bstate.mu.position), atol=0
    )


def test_update_bank_dispatcher_generic_path():
    bstate, params = _make_bank(2)
    z = jnp.asarray(RNG.normal(scale=0.3, size=(2, 3)), jnp.float32)
    r = jnp.eye(3, dtype=jnp.float32) * 1e-3
    out, info = pukf.update_velocity_bank(bstate, params, z, r, use_fused=False)
    ref = jax.vmap(lambda s, zz: pukf.update_velocity(s, params, zz, r)[0])(bstate, z)
    np.testing.assert_allclose(np.asarray(out.cov), np.asarray(ref.cov), atol=1e-7)


@pytest.mark.slow
@pytest.mark.time_limit(210)
def test_fused_update_all_measurement_models():
    """Every bank-level fused wrapper matches its per-instance generic update
    (interpret mode; exercises deps slicing for 1-, 2-, 3- and 6-dim models
    including mat33-dependent body efforts and the gated ADCP blend)."""
    bstate, params = _make_bank(2)
    s0 = jax.tree_util.tree_map(lambda a: a[0], bstate)
    r1 = jnp.eye(1, dtype=jnp.float32) * 1e-2
    r2 = jnp.eye(2, dtype=jnp.float32) * 1e-3
    r3 = jnp.eye(3, dtype=jnp.float32) * 1e-3
    r6 = jnp.eye(6, dtype=jnp.float32) * 1e-1
    rr_body = pukf.get_rotation_rate(s0, params)

    cases = [
        ("acceleration",
         lambda bs, z: pukf.update_acceleration_bank(bs, params, z, r3, use_fused="interpret"),
         lambda s, z: pukf.update_acceleration(s, params, z, r3),
         jnp.asarray(RNG.normal(scale=0.5, size=(2, 3)), jnp.float32)),
        ("z_position",
         lambda bs, z: pukf.update_z_position_bank(bs, params, z, r1, use_fused="interpret"),
         lambda s, z: pukf.update_z_position(s, params, z, r1),
         jnp.asarray(RNG.normal(scale=1.0, size=(2, 1)), jnp.float32)),
        ("xy_position",
         lambda bs, z: pukf.update_xy_position_bank(bs, params, z, r2, use_fused="interpret"),
         lambda s, z: pukf.update_xy_position(s, params, z, r2),
         jnp.asarray(RNG.normal(scale=1.0, size=(2, 2)), jnp.float32)),
        ("pressure",
         lambda bs, z: pukf.update_pressure_bank(bs, params, z, r1 * 1e4, use_fused="interpret"),
         lambda s, z: pukf.update_pressure(s, params, z, r1 * 1e4),
         jnp.asarray(101325.0 + RNG.normal(scale=100.0, size=(2, 1)), jnp.float32)),
        ("water_velocity",
         lambda bs, z: pukf.update_water_velocity_bank(bs, params, z, r2, 0.7, use_fused="interpret"),
         lambda s, z: pukf.update_water_velocity(s, params, z, r2, 0.7),
         jnp.asarray(RNG.normal(scale=0.1, size=(2, 2)), jnp.float32)),
        ("body_efforts",
         lambda bs, z: pukf.update_body_efforts_bank(bs, params, z, r6, rr_body, use_fused="interpret"),
         lambda s, z: (_bef(s, z),),
         jnp.asarray(RNG.normal(scale=1.0, size=(2, 6)), jnp.float32)),
    ]

    def _bef(s, z):
        # generic single-instance body-efforts with the same shared body rate
        from slam_uwv_kalman_filters_tpu.ops import ukf as ukfmod
        h = lambda chi: pukf._efforts_measurement(chi, params, rr_body)
        mu, cov, info = ukfmod.update(pukf.POSE_MANIFOLD, s.mu, s.cov, z, h, r6)
        return s._replace(mu=mu, cov=cov)

    # use_fused="interpret" drives the REAL dispatch branches (generic fused
    # tail and in-kernel-model entry points) in Pallas interpret mode
    for name, bank_fn, one_fn, z in cases:
        out = bank_fn(bstate, z)
        out_s = out[0] if isinstance(out, tuple) else out
        ref = one_fn(s0, z[0])
        ref_s = ref[0] if isinstance(ref, tuple) else ref
        np.testing.assert_allclose(
            np.asarray(out_s.cov[0]), np.asarray(ref_s.cov), rtol=5e-3, atol=5e-5,
            err_msg=name,
        )
        np.testing.assert_allclose(
            np.asarray(out_s.mu.position[0]), np.asarray(ref_s.mu.position),
            rtol=1e-4, atol=1e-4, err_msg=name,
        )


def test_update_bank_rejects_banked_params():
    """The generic ``update_bank`` entry rejects banked parameter sets when
    ``h`` may close over params it cannot re-close per instance. The TYPED
    parameter-dependent entries route banked values per instance instead —
    pinned by test_update_pressure_bank_accepts_banked_params."""
    bstate, params = _make_bank(2)
    params_bank = jax.vmap(lambda s: params._replace(process_noise=params.process_noise * s))(
        jnp.asarray([1.0, 2.0], jnp.float32)
    )
    z = jnp.zeros((2, 1), jnp.float32)
    r = jnp.eye(1, dtype=jnp.float32) * 1e2
    try:
        pukf.update_bank(
            bstate, params_bank, z, r, lambda s: s.position[2:3], ("position",)
        )
        assert False, "expected ValueError for banked params"
    except ValueError as e:
        assert "banked parameter set" in str(e)


def test_update_pressure_bank_accepts_banked_params():
    """Banked ``atmospheric_pressure`` (Monte-Carlo sweep): the fused route
    carries per-instance values on the kernel's banked-aux lanes, the generic
    route vmaps per instance — both match vmap(update_pressure)."""
    bstate, params = _make_bank(3)
    p_atms = params.atmospheric_pressure * jnp.asarray([0.9, 1.0, 1.1], jnp.float32)
    params_bank = jax.vmap(
        lambda s, pa: params._replace(
            process_noise=params.process_noise * s, atmospheric_pressure=pa
        )
    )(jnp.asarray([0.5, 1.0, 2.0], jnp.float32), p_atms)
    lever = jnp.asarray([0.1, -0.2, 0.3], jnp.float32)
    z = p_atms[:, None] * 1.001  # plausible pressures near each instance's p_atm
    r = jnp.eye(1, dtype=jnp.float32) * 1e2

    ref = jax.vmap(lambda st, pr, zz: pukf.update_pressure(st, pr, zz, r, lever))(
        bstate, params_bank, z
    )[0]
    # generic (CPU) banked route: per-instance vmap inside update_pressure_bank
    out, _ = pukf.update_pressure_bank(bstate, params_bank, z, r, lever, use_fused=False)
    np.testing.assert_allclose(np.asarray(out.cov), np.asarray(ref.cov), atol=2e-6)
    np.testing.assert_allclose(
        np.asarray(out.mu.position), np.asarray(ref.mu.position), atol=1e-6
    )
    # fused banked-aux route through the REAL dispatch branch (interpret mode
    # = the TPU kernel's code path, aux_bank packed by update_pressure_bank
    # itself so the dispatch packing can't drift from what this test pins)
    # tolerances: the streaming kernel sums {0, +cols, −cols} instead of the
    # generic path's interleaved ±ordering — f32 ulp-level shifts only
    out2, _ = pukf.update_pressure_bank(
        bstate, params_bank, z, r, lever, use_fused="interpret"
    )
    np.testing.assert_allclose(np.asarray(out2.cov), np.asarray(ref.cov), atol=2e-6)
    np.testing.assert_allclose(
        np.asarray(out2.mu.position), np.asarray(ref.mu.position), atol=5e-6
    )
    np.testing.assert_allclose(
        np.asarray(out2.mu.water_density), np.asarray(ref.mu.water_density), atol=5e-6
    )


def test_update_model_fused_banked_rejects_mixed_aux():
    """Passing both shared aux scalars and a per-instance aux_bank is an
    error: the kernel reads only the banked lanes, so mixed entries would
    silently zero the shared values (ADVICE r1)."""
    from slam_uwv_kalman_filters_tpu.models import pose_update_fused as puf

    bstate, _ = _make_bank(2)
    z = jnp.zeros((2, 1), jnp.float32)
    r = jnp.eye(1, dtype=jnp.float32)
    try:
        puf.update_model_fused_banked(
            "pressure", bstate, z, r,
            aux=(101325.0,), aux_bank=jnp.zeros((2, 4), jnp.float32),
        )
        assert False, "expected ValueError for mixed aux/aux_bank"
    except ValueError as e:
        assert "aux_bank" in str(e)


def test_update_water_velocity_bank_per_instance_cell_weighting():
    """Per-instance ADCP cell weightings (each instance's ADCP cell is its own
    measurement attribute): fused banked-aux route and generic per-instance
    vmap both match vmap(update_water_velocity)."""
    bstate, params = _make_bank(3)
    cw = jnp.asarray([0.0, 0.4, 1.0], jnp.float32)
    z = jnp.asarray(RNG.normal(scale=0.05, size=(3, 2)), jnp.float32)
    r = jnp.eye(2, dtype=jnp.float32) * 1e-2

    ref = jax.vmap(lambda st, zz, c: pukf.update_water_velocity(st, params, zz, r, c))(
        bstate, z, cw
    )[0]
    out, _ = pukf.update_water_velocity_bank(bstate, params, z, r, cw, use_fused=False)
    np.testing.assert_allclose(np.asarray(out.cov), np.asarray(ref.cov), atol=2e-6)
    np.testing.assert_allclose(
        np.asarray(out.mu.water_velocity), np.asarray(ref.mu.water_velocity), atol=1e-6
    )
    # fused banked-aux route through the REAL dispatch branch (interpret mode)
    out2, info2 = pukf.update_water_velocity_bank(
        bstate, params, z, r, cw, use_fused="interpret"
    )
    np.testing.assert_allclose(np.asarray(out2.cov), np.asarray(ref.cov), atol=2e-6)
    np.testing.assert_allclose(
        np.asarray(out2.mu.water_velocity), np.asarray(ref.mu.water_velocity), atol=1e-6
    )
    assert bool(np.all(np.asarray(info2.accepted)))


@pytest.mark.slow
@pytest.mark.time_limit(240)
def test_update_velocity_fused_h_matches_generic():
    """The whole-update DVL kernel (measurement model fused in-kernel,
    update_velocity_lanes / update_velocity_fused_banked) matches the generic
    deltas → XLA-h → tail pipeline to f32 roundoff, including χ² gating."""
    from slam_uwv_kalman_filters_tpu.models import pose_update_fused as puf

    bstate, params = _make_bank(3)
    # de-trivialize: distinct rotations/velocities per instance
    rv = jnp.asarray(RNG.normal(scale=0.4, size=(3, 3)), jnp.float32)
    q = jax.vmap(mf.quat_exp)(rv)
    vel = jnp.asarray(RNG.normal(scale=1.0, size=(3, 3)), jnp.float32)
    bstate = bstate._replace(mu=bstate.mu._replace(orientation=q, velocity=vel))
    z = jnp.asarray(RNG.normal(scale=0.5, size=(3, 3)), jnp.float32)
    r = jnp.eye(3, dtype=jnp.float32) * 1e-3
    h = lambda s: mf.quat_rotate_inv(s.orientation, s.velocity)
    deps = ("orientation", "velocity")

    ls = pose_fused.to_lanes(bstate)
    ls = pose_fused.predict_lanes(ls, params, 0.05, interpret=True)
    for gate in (None, 5.991):
        g, gi = puf.update_lanes(ls, params, z, r, h, deps, gate, interpret=True)
        f, fi = puf.update_velocity_lanes(ls, params, z, r, gate, interpret=True)
        go, fo = pose_fused.from_lanes(g, bstate), pose_fused.from_lanes(f, bstate)
        np.testing.assert_allclose(np.asarray(fo.cov), np.asarray(go.cov), atol=2e-6)
        np.testing.assert_allclose(
            np.asarray(fo.mu.velocity), np.asarray(go.mu.velocity), atol=2e-6
        )
        np.testing.assert_allclose(
            np.asarray(fi.mahalanobis2), np.asarray(gi.mahalanobis2), rtol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(fi.innovation), np.asarray(gi.innovation), atol=2e-6
        )
        np.testing.assert_array_equal(np.asarray(fi.accepted), np.asarray(gi.accepted))

    # public bank entry agrees with the lanes entry bit-for-bit
    pre = pose_fused.from_lanes(ls, bstate)
    pre = pre._replace(cov=0.5 * (pre.cov + jnp.swapaxes(pre.cov, -1, -2)))
    fb, _ = puf.update_velocity_fused_banked(pre, params, z, r, None, interpret=True)
    fl, _ = puf.update_velocity_lanes(pose_fused.to_lanes(pre), params, z, r, None, interpret=True)
    flo = pose_fused.from_lanes(fl, pre)
    np.testing.assert_allclose(np.asarray(fb.mu.velocity), np.asarray(flo.mu.velocity), atol=0)


def test_update_velocity_bank_accepts_banked_params():
    """The DVL measurement model reads no parameters, so update_velocity_bank
    serves Monte-Carlo parameter banks too (both the fused in-kernel route
    and the generic params_independent fallback) — matching per-instance
    vmap(update_velocity)."""
    bstate, params = _make_bank(3)
    scales = jnp.asarray([0.5, 1.0, 2.0], jnp.float32)
    params_bank = jax.vmap(
        lambda s: params._replace(process_noise=params.process_noise * s)
    )(scales)
    z = jnp.asarray(RNG.normal(scale=0.3, size=(3, 3)), jnp.float32)
    r = jnp.tile((jnp.eye(3, dtype=jnp.float32) * 1e-3)[None], (3, 1, 1))

    ref = jax.vmap(lambda st, pr, zz, rr: pukf.update_velocity(st, pr, zz, rr))(
        bstate, params_bank, z, r
    )[0]
    # generic route (CPU): no longer raises for params-independent h
    out, _ = pukf.update_velocity_bank(bstate, params_bank, z, r, use_fused=False)
    np.testing.assert_allclose(np.asarray(out.cov), np.asarray(ref.cov), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(out.mu.velocity), np.asarray(ref.mu.velocity), atol=1e-6
    )
    # fused in-kernel route (interpret): same result
    from slam_uwv_kalman_filters_tpu.models import pose_update_fused as puf

    out2, _ = puf.update_velocity_fused_banked(bstate, params_bank, z, r, interpret=True)
    np.testing.assert_allclose(np.asarray(out2.cov), np.asarray(ref.cov), atol=2e-6)


@pytest.mark.slow
@pytest.mark.time_limit(420)
def test_all_in_kernel_measurement_models_match_generic():
    """Every in-kernel measurement model (FUSED_MODELS) matches the generic
    deltas → XLA-h → tail pipeline to f32 roundoff on a de-trivialized bank."""
    from slam_uwv_kalman_filters_tpu.models import pose_update_fused as puf
    from slam_uwv_kalman_filters_tpu.ops import ukf as ukf_ops

    bstate, params = _make_bank(2)
    rv = jnp.asarray(RNG.normal(scale=0.4, size=(2, 3)), jnp.float32)
    bstate = bstate._replace(
        mu=bstate.mu._replace(
            orientation=jax.vmap(mf.quat_exp)(rv),
            position=jnp.asarray(RNG.normal(scale=5.0, size=(2, 3)), jnp.float32),
            velocity=jnp.asarray(RNG.normal(size=(2, 3)), jnp.float32),
            acceleration=jnp.asarray(RNG.normal(scale=0.3, size=(2, 3)), jnp.float32),
            water_velocity=jnp.asarray(RNG.normal(scale=0.2, size=(2, 2)), jnp.float32),
            water_velocity_below=jnp.asarray(RNG.normal(scale=0.2, size=(2, 2)), jnp.float32),
        )
    )
    ls = pose_fused.to_lanes(bstate)
    ls = pose_fused.predict_lanes(ls, params, 0.05, interpret=True)

    p_atm = float(params.atmospheric_pressure)
    lever = (0.1, -0.2, 0.3)
    cw = 0.7
    cases = {
        "velocity": (
            lambda s: mf.quat_rotate_inv(s.orientation, s.velocity),
            ("orientation", "velocity"), (), None,
        ),
        "z_position": (lambda s: s.position[2:3], ("position",), (), None),
        "xy_position": (lambda s: s.position[:2], ("position",), (), ukf_ops.D2P95),
        "acceleration": (
            lambda s: mf.quat_rotate_inv(
                s.orientation,
                s.acceleration + jnp.stack([jnp.zeros((), jnp.float32),
                                            jnp.zeros((), jnp.float32), s.gravity[0]]),
            )
            + s.bias_acc,
            ("orientation", "acceleration", "bias_acc", "gravity"), (), None,
        ),
        "pressure": (
            lambda s: (
                p_atm
                - (s.position + mf.quat_rotate(s.orientation, jnp.asarray(lever, jnp.float32)))[2]
                * s.gravity[0] * s.water_density[0]
            )[None],
            ("position", "orientation", "gravity", "water_density"),
            (p_atm, *lever), None,
        ),
        "water_velocity": (
            lambda s: (
                cw * mf.quat_rotate_inv(
                    s.orientation,
                    s.velocity - jnp.stack([s.water_velocity_below[0],
                                            s.water_velocity_below[1],
                                            jnp.zeros((), jnp.float32)]),
                )[:2]
                + (1.0 - cw) * mf.quat_rotate_inv(
                    s.orientation,
                    s.velocity - jnp.stack([s.water_velocity[0], s.water_velocity[1],
                                            jnp.zeros((), jnp.float32)]),
                )[:2]
                + s.bias_adcp
            ),
            ("orientation", "velocity", "water_velocity", "water_velocity_below", "bias_adcp"),
            (cw,), ukf_ops.D2P95,
        ),
    }
    # body_efforts needs per-instance aux (each instance's body rate), which
    # this simple (h, deps) harness cannot express — its in-kernel-vs-generic
    # parity is pinned by test_body_efforts_in_kernel_model_matches_generic
    assert set(cases) | {"body_efforts"} == set(puf.FUSED_MODELS)
    for model, (h, deps, aux, gate) in cases.items():
        m = puf.FUSED_MODELS[model]
        z = jnp.asarray(RNG.normal(scale=0.5, size=(2, m)), jnp.float32)
        if model == "pressure":
            z = z * 1e3 + p_atm  # plausible pressures, not ~0
        r = jnp.eye(m, dtype=jnp.float32) * (1e2 if model == "pressure" else 1e-3)
        g, gi = puf.update_lanes(ls, params, z, r, h, deps, gate, interpret=True)
        f, fi = puf.update_model_lanes(model, ls, z, r, gate, aux, interpret=True)
        go, fo = pose_fused.from_lanes(g, bstate), pose_fused.from_lanes(f, bstate)
        scale = float(jnp.max(jnp.abs(go.cov)))
        np.testing.assert_allclose(
            np.asarray(fo.cov), np.asarray(go.cov), atol=3e-6 * max(1.0, scale),
            err_msg=model,
        )
        np.testing.assert_allclose(
            np.asarray(fo.mu.position), np.asarray(go.mu.position), atol=5e-5,
            err_msg=model,
        )
        np.testing.assert_allclose(
            np.asarray(fi.mahalanobis2), np.asarray(gi.mahalanobis2),
            rtol=2e-4, atol=1e-5, err_msg=model,
        )
        np.testing.assert_array_equal(
            np.asarray(fi.accepted), np.asarray(gi.accepted), err_msg=model
        )


def test_fused_update_pins_f64_h_output_to_state_dtype():
    """A measurement model that reads float64 parameters must not push f64
    deviations into the f32 kernel (regression: Mosaic cannot lower f64; in
    interpret mode the f64 values were silently written into f32 refs).
    Policy matches ops.ukf.update: the state's dtype governs."""
    from slam_uwv_kalman_filters_tpu.models import pose_update_fused as puf

    bstate, params = _make_bank(2)
    z = jnp.asarray(RNG.normal(scale=0.2, size=(2, 3)), jnp.float32)
    r = jnp.tile((jnp.eye(3, dtype=jnp.float32) * 1e-3)[None], (2, 1, 1))

    f64_scale = jnp.asarray(1.0, jnp.float64)  # a "param" that promotes

    def h(s):
        return mf.quat_rotate_inv(s.orientation, s.velocity) * f64_scale

    out, info = puf.update_fused_banked(
        bstate, params, z, r, h, ("orientation", "velocity"), None, interpret=True
    )
    assert out.cov.dtype == jnp.float32
    assert np.all(np.isfinite(np.asarray(out.cov)))
    # and matches the un-promoted model exactly (scale is 1.0)
    ref, _ = puf.update_fused_banked(
        bstate, params, z, r,
        lambda s: mf.quat_rotate_inv(s.orientation, s.velocity),
        ("orientation", "velocity"), None, interpret=True,
    )
    np.testing.assert_allclose(np.asarray(out.cov), np.asarray(ref.cov), atol=0)


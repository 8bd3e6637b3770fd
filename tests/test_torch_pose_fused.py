"""Parity of the PyTorch port's lanes path (the plain versions of kernels K2
and K3, which a CPU tensor takes) with the JAX package's generic bank chain
(float64, CPU): prediction, the seven in-kernel measurement models in both
aux forms, the gate, the half-triangle protocol, and one full mission second
(100 ticks) at bank 2.

Tolerances: one predict or update is held to rtol 1e-8 / atol 1e-10, as in
test_torch_pose_ukf.py (the lanes predict runs a fixed 4-iteration
quaternion mean where JAX runs a 1e-12 tolerance loop; both converge within
2). After 100 ticks the two chains have each rounded ~220 factorizations in
their own order, so the end state is held to rtol 1e-6 / atol 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_uwv_kalman_filters_tpu.models import pose_ukf as jpukf
from slam_uwv_kalman_filters_tpu.ops import geodesy as jgeo
from slam_uwv_kalman_filters_tpu.ops import ukf as jukf
from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as tf
from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as tu
from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib

from torch_parity import DT, assert_tree_close, jx, mission_init, pt, random_bank

STEP = dict(rtol=1e-8, atol=1e-10)


def _lanes(bstate_np):
    """Port lanes state with NaN in the invalid half of the covariance: the
    lanes functions must read only cov_t[c, r ≥ c]."""
    ls = tf.to_lanes(pt(bstate_np))
    n = tf.TANGENT_DIM
    upper = torch.tril(torch.ones(n, n, dtype=torch.bool), -1)[..., None]
    return ls._replace(cov_t=torch.where(upper, torch.full_like(ls.cov_t, float("nan")), ls.cov_t))


@pytest.fixture(scope="module")
def bank():
    state, params = mission_init()
    return random_bank(np.random.default_rng(30), state, 3), params


def test_predict_lanes_matches_jax(bank):
    bstate, params = bank
    ref = jax.jit(lambda s, p: jpukf.predict_bank(s, p, DT))(jx(bstate), jx(params))
    ls = tf.predict_lanes(_lanes(bstate), pt(params), DT)
    assert_tree_close(tf.from_lanes(ls, pt(bstate)), ref, **STEP)
    # the public bank entry of the fused predict gives the same
    assert_tree_close(tf.predict_fused_banked(pt(bstate), pt(params), DT), ref, **STEP)


def _case(name, bstate, params, rng):
    """(z, R, JAX generic bank update, port lanes kwargs for shared aux,
    port lanes kwargs for banked aux)."""
    nb = bstate.cov.shape[0]
    p = jx(params)
    mu = jx(bstate.mu)
    std = {"velocity": 0.03, "z_position": 0.1, "xy_position": 0.7, "acceleration": 0.006,
           "pressure": 50.0, "water_velocity": 0.03, "body_efforts": 1.0}[name]
    gate = jukf.D2P95 if name in ("xy_position", "water_velocity") else None
    if name == "pressure":
        p_atm = p.atmospheric_pressure + rng.normal(0.0, 200.0, nb)  # per instance
        h = lambda m, pa: jpukf._h_pressure(pa, jnp.zeros(3))(m)
        truth = jax.vmap(h)(mu, p_atm)
        ref = lambda s, zz, r, shared: jpukf.update_pressure_bank(
            s, p if shared else p._replace(atmospheric_pressure=p_atm), zz, r)
        shared_kw = dict(aux=(float(params.atmospheric_pressure), 0.0, 0.0, 0.0))
        banked_kw = dict(aux_bank=torch.tensor(np.stack([np.asarray(p_atm)] + [np.zeros(nb)] * 3, 1)))
    elif name == "water_velocity":
        cw = rng.uniform(0.0, 1.0, nb)
        truth = jax.vmap(lambda m, c: jpukf._h_water_velocity(c)(m))(mu, cw)
        ref = lambda s, zz, r, shared: jpukf.update_water_velocity_bank(
            s, p, zz, r, 0.5 if shared else jnp.asarray(cw))
        shared_kw = dict(aux=(0.5,))
        banked_kw = dict(aux_bank=torch.tensor(cw[:, None]))
    elif name == "body_efforts":
        rr = jpukf.get_rotation_rate_bank(jx(bstate), p)
        truth = jax.vmap(lambda m, r: jpukf._efforts_measurement(m, p, r))(mu, rr)
        rr0 = rr[0]
        ref = lambda s, zz, r, shared: jpukf.update_body_efforts_bank(s, p, zz, r, rr0 if shared else rr)
        mscal = tu._efforts_model_scal(pt(params), torch.float64)
        shared_kw = dict(aux=tuple(float(x) for x in rr0), mscal=mscal)
        banked_kw = dict(aux_bank=torch.tensor(np.asarray(rr)), mscal=mscal)
    else:
        truth = jax.vmap(getattr(jpukf, f"_h_{name}"))(mu)
        fn = getattr(jpukf, f"update_{name}_bank")
        ref = lambda s, zz, r, shared: fn(s, p, zz, r, *(() if gate is None else (gate,)))
        shared_kw = {}
        banked_kw = dict(aux_bank=torch.zeros(nb, 1, dtype=torch.float64))  # no aux read
    z = np.asarray(truth) + rng.normal(0.0, std, truth.shape)
    if gate is not None:
        z[0] += 20.0  # instance 0 fails the χ²-95 gate
    meas_cov = np.eye(z.shape[1]) * std**2
    return z, meas_cov, gate, ref, shared_kw, banked_kw


@pytest.mark.parametrize("aux_form", ["shared", "banked"])
@pytest.mark.parametrize("name", list(tu.FUSED_MODELS))
def test_update_model_lanes_matches_jax(bank, name, aux_form):
    bstate, params = bank
    rng = np.random.default_rng(40 + list(tu.FUSED_MODELS).index(name))
    z, meas_cov, gate, ref, shared_kw, banked_kw = _case(name, bstate, params, rng)
    shared = aux_form == "shared"
    ref_state, ref_info = jax.jit(lambda s, zz, r: ref(s, zz, r, shared))(
        jx(bstate), jnp.asarray(z), jnp.asarray(meas_cov))
    ls, info = tu.update_model_lanes(
        name, _lanes(bstate), torch.tensor(z), torch.tensor(meas_cov), gate,
        **(shared_kw if shared else banked_kw),
    )
    assert_tree_close(tf.from_lanes(ls, pt(bstate)), ref_state, **STEP, what=name)
    np.testing.assert_array_equal(info.accepted.numpy(), np.asarray(ref_info.accepted))
    np.testing.assert_allclose(info.mahalanobis2.numpy(), np.asarray(ref_info.mahalanobis2), **STEP)
    np.testing.assert_allclose(info.innovation.numpy(), np.asarray(ref_info.innovation), **STEP)
    if gate is not None:
        assert not bool(info.accepted[0]) and bool(info.accepted[1:].all())


def test_gate_is_a_select(bank):
    bstate, params = bank
    ls = _lanes(bstate)
    z = torch.tensor(np.asarray(jax.vmap(jpukf._h_xy_position)(jx(bstate.mu)))) + 1e3
    # threshold < 0 accepts any innovation
    _, info = tu.update_model_lanes("xy_position", ls, z, torch.eye(2) * 0.01)
    assert bool(info.accepted.all())
    # a NaN S rejects, and leaves the instance bit-identical to its prior
    r = torch.eye(2, dtype=torch.float64).repeat(3, 1, 1)
    r[1, 0, 0] = float("nan")
    out, info = tu.update_model_lanes("xy_position", ls, z - 1e3, r, jukf.D2P95)
    assert info.accepted.tolist() == [True, False, True]
    valid = torch.triu(torch.ones(53, 53, dtype=torch.bool))
    assert torch.equal(out.cov_t[..., 1][valid], ls.cov_t[..., 1][valid])
    assert torch.equal(out.mu_t[:, 1], ls.mu_t[:, 1])


def test_cpu_tensors_take_the_plain_route(bank):
    bstate, params = bank
    cuda_lib.reset_launch_counts()
    tf.predict_lanes(_lanes(bstate), pt(params), DT)
    tu.update_velocity_lanes(_lanes(bstate), pt(params), torch.zeros(3, 3), torch.eye(3))
    assert all(k.launches == 0 for k in cuda_lib.KERNELS.values())


# the bench's mission second (bench.py FULL_TICKS schedule)
_DVL_AT = lambda k: k % 20 == 19  # 5 Hz
_PRESS_AT = lambda k: k % 50 == 49  # 2 Hz
_ADCP_AT = lambda k: k % 100 == 99  # 1 Hz
_EFF_AT = lambda k: k % 10 == 9  # 10 Hz


def test_mission_second_matches_jax_generic_chain():
    state, params = mission_init()
    rng = np.random.default_rng(50)
    nb = 2
    bstate = jax.tree.map(lambda a: np.broadcast_to(a, (nb, *np.shape(a))).copy(), state)
    bstate = bstate._replace(
        mu=bstate.mu._replace(
            position=bstate.mu.position + rng.normal(0, 0.1, (nb, 3)),
            velocity=bstate.mu.velocity + rng.normal(0, 0.1, (nb, 3)),
        ),
        rotation_rate=np.broadcast_to([0.0, 0.0, 0.01], (nb, 3)).copy(),
    )
    g = float(jgeo.wgs84_gravity(0.822, 0.0))
    meas = {
        "acc": (np.tile([0.0, 0.0, g], (nb, 1)), np.eye(3) * 4e-5),
        "dvl": (np.tile([0.3, 0.0, 0.0], (nb, 1)), np.eye(3) * 1e-3),
        "press": (np.full((nb, 1), float(params.atmospheric_pressure)), np.eye(1) * 2500.0),
        "adcp": (np.zeros((nb, 2)), np.eye(2) * 1e-3),
        "eff": (np.zeros((nb, 6)), np.eye(6)),
    }
    jm = {k: (jnp.asarray(a), jnp.asarray(b)) for k, (a, b) in meas.items()}
    tm = {k: (torch.tensor(a), torch.tensor(b)) for k, (a, b) in meas.items()}

    p = jx(params)
    j_pred = jax.jit(lambda s: jpukf.predict_bank(s, p, DT))
    j_acc = jax.jit(lambda s: jpukf.update_acceleration_bank(s, p, *jm["acc"])[0])
    j_dvl = jax.jit(lambda s: jpukf.update_velocity_bank(s, p, *jm["dvl"])[0])
    j_press = jax.jit(lambda s: jpukf.update_pressure_bank(s, p, *jm["press"])[0])
    j_adcp = jax.jit(lambda s: jpukf.update_water_velocity_bank(s, p, *jm["adcp"], 0.5)[0])
    j_eff = jax.jit(lambda s: jpukf.update_body_efforts_bank(
        s, p, *jm["eff"], jpukf.get_rotation_rate_bank(s, p))[0])

    tparams = pt(params)
    p_atm = tparams.atmospheric_pressure
    js, ls = jx(bstate), tf.to_lanes(pt(bstate))
    for k in range(100):
        js = j_acc(j_pred(js))
        ls = tf.predict_lanes(ls, tparams, DT)
        ls, _ = tu.update_model_lanes("acceleration", ls, *tm["acc"])
        if _DVL_AT(k):
            js = j_dvl(js)
            ls, _ = tu.update_velocity_lanes(ls, tparams, *tm["dvl"])
        if _PRESS_AT(k):
            js = j_press(js)
            ls, _ = tu.update_model_lanes("pressure", ls, *tm["press"], aux=(p_atm, 0.0, 0.0, 0.0))
        if _ADCP_AT(k):
            js = j_adcp(js)
            ls, _ = tu.update_model_lanes("water_velocity", ls, *tm["adcp"], jukf.D2P95, aux=(0.5,))
        if _EFF_AT(k):
            js = j_eff(js)
            ls, _ = tu.update_body_efforts_lanes(ls, tparams, *tm["eff"])
    out = tf.from_lanes(ls, pt(bstate))
    assert torch.isfinite(out.cov).all()
    assert_tree_close(out, js, rtol=1e-6, atol=1e-9, what="mission")


# ---------------------------------------------------------------------------
# the banked (Monte-Carlo) path: K2's full mode, the generic-h route (K4)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def banked():
    from torch_parity import banked_params

    state, params = mission_init()
    rng = np.random.default_rng(60)
    return random_bank(rng, state, 3), banked_params(rng, params, 3)


def test_banked_predict_operands_match_jax(banked):
    from slam_uwv_kalman_filters_tpu.models import pose_fused as jpf

    _, bparams = banked
    ref = jpf.banked_predict_operands(jx(bparams), DT, jnp.float64, 3)
    out = tf.banked_predict_operands(pt(bparams), DT, torch.float64)
    for name in ref._fields:
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-12, atol=0, err_msg=name)
    with pytest.raises(ValueError, match="fully banked"):
        tf.banked_predict_operands(pt(bparams)._replace(inertia_tau=torch.tensor(1.0)), DT, torch.float64)


def test_banked_predict_lanes_matches_jax(banked):
    """K2's full mode (plain) against JAX's per-instance generic predict."""
    bstate, bparams = banked
    ref = jax.jit(lambda s, p: jpukf.predict_bank(s, p, DT))(jx(bstate), jx(bparams))
    ls = tf.predict_lanes(_lanes(bstate), pt(bparams), DT)
    assert_tree_close(tf.from_lanes(ls, pt(bstate)), ref, **STEP, what="lanes")
    ops = tf.banked_predict_operands(pt(bparams), DT, torch.float64)
    ls = tf.predict_lanes(_lanes(bstate), pt(bparams), DT, banked_ops=ops)
    assert_tree_close(tf.from_lanes(ls, pt(bstate)), ref, **STEP, what="prebuilt operands")
    assert_tree_close(tf.predict_fused_banked(pt(bstate), pt(bparams), DT), ref, **STEP, what="fused bank")
    from slam_uwv_kalman_filters_tpu_torch.models import pose_ukf as tpukf

    assert_tree_close(tpukf.predict_bank(pt(bstate), pt(bparams), DT), ref, **STEP, what="generic bank")


# custom measurement models: name → (JAX h on one state, port h on a bank of
# sigma points, deps)
_CUSTOM_H = {
    1: (lambda s: s.position[2:3], lambda s: s.position[..., 2:3], ("position",)),
    2: (lambda s: s.position[:2], lambda s: s.position[..., :2], ("position",)),
    3: (jpukf._h_velocity, lambda s: tu.mf.quat_rotate_inv(s.orientation, s.velocity),
        ("orientation", "velocity")),
    6: (lambda s: jnp.concatenate([s.position, jpukf._h_velocity(s)]),
        lambda s: torch.cat([s.position, tu.mf.quat_rotate_inv(s.orientation, s.velocity)], -1),
        ("position", "orientation", "velocity")),
}


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("m", sorted(_CUSTOM_H))
def test_update_lanes_custom_h_matches_jax(bank, m, gated):
    """The generic-h route (K1 deltas of the half-valid covariance, h in
    PyTorch, the K4 tail; plain versions) against JAX's generic update_bank,
    for m = 1, 2, 3, 6, with and without the χ²-95 gate."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_ukf as tpukf

    bstate, params = bank
    jh, th, deps = _CUSTOM_H[m]
    rng = np.random.default_rng(70 + m)
    truth = np.asarray(jax.vmap(jh)(jx(bstate.mu)))
    z = truth + rng.normal(0.0, 0.1, truth.shape)
    gate = 2.0 * jukf.D2P95 * m if gated else None
    if gated:
        z[0] += 20.0  # instance 0 fails the gate
    meas_cov = np.eye(m) * 0.01
    ref_state, ref_info = jax.jit(lambda s, zz, r: jpukf.update_bank(s, jx(params), zz, r, jh, deps, gate))(
        jx(bstate), jnp.asarray(z), jnp.asarray(meas_cov))
    ls, info = tu.update_lanes(_lanes(bstate), pt(params), torch.tensor(z), torch.tensor(meas_cov), th, deps, gate)
    assert_tree_close(tf.from_lanes(ls, pt(bstate)), ref_state, **STEP, what=f"m={m}")
    np.testing.assert_array_equal(info.accepted.numpy(), np.asarray(ref_info.accepted))
    np.testing.assert_allclose(info.mahalanobis2.numpy(), np.asarray(ref_info.mahalanobis2), **STEP)
    np.testing.assert_allclose(info.innovation.numpy(), np.asarray(ref_info.innovation), **STEP)
    if gated:
        assert not bool(info.accepted[0]) and bool(info.accepted[1:].all())
    for out_state, _ in (tu.update_fused_banked(pt(bstate), pt(params), torch.tensor(z), torch.tensor(meas_cov),
                                                th, deps, gate),
                         tpukf.update_bank(pt(bstate), pt(params), torch.tensor(z), torch.tensor(meas_cov),
                                           th, deps, gate)):
        assert_tree_close(out_state, ref_state, **STEP, what=f"m={m} bank-first")


def test_banked_model_body_efforts_matches_jax(banked):
    """Body efforts with a per-instance vehicle model: the lanes route
    (generic-h, K4 plain) and the generic bank route against JAX's
    per-instance update_body_efforts."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_ukf as tpukf

    bstate, bparams = banked
    rng = np.random.default_rng(80)
    z = rng.normal(0.0, 1.0, (3, 6))
    meas_cov = np.eye(6)
    ref_state, ref_info = jax.jit(jax.vmap(lambda s, p, zz: jpukf.update_body_efforts(s, p, zz, jnp.asarray(meas_cov))))(
        jx(bstate), jx(bparams), jnp.asarray(z))
    ls, info = tu.update_body_efforts_lanes(_lanes(bstate), pt(bparams), torch.tensor(z), torch.tensor(meas_cov))
    assert_tree_close(tf.from_lanes(ls, pt(bstate)), ref_state, **STEP, what="lanes")
    np.testing.assert_allclose(info.mahalanobis2.numpy(), np.asarray(ref_info.mahalanobis2), **STEP)
    tb, tp = pt(bstate), pt(bparams)
    out, _ = tpukf.update_body_efforts_bank(tb, tp, torch.tensor(z), torch.tensor(meas_cov),
                                            tpukf.get_rotation_rate_bank(tb, tp))
    assert_tree_close(out, ref_state, **STEP, what="generic bank")


def test_update_tail_takes_m_up_to_six(bank):
    bstate, params = bank
    h = lambda s: torch.cat([s.position, s.velocity, s.acceleration[..., :1]], -1)
    with pytest.raises(ValueError, match="MAX_TAIL_M"):
        tu.update_lanes(_lanes(bstate), pt(params), torch.zeros(3, 7, dtype=torch.float64), torch.eye(7), h,
                        ("position", "velocity", "acceleration"))

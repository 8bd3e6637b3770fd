"""Parity of the PyTorch port's whole PoseUKF step (``step_lanes``, the plain
version of kernel K5, which a CPU tensor takes) with the JAX package's
generic bank chain — ``predict_bank`` followed by the matching
``update_*_bank`` calls in the chain's order — at float64 on the CPU. The
JAX package holds its own ``step_lanes`` bit-identical to that chain.

Tolerances: one step is held to rtol 1e-8 / atol 1e-10 (the port's lanes
predict runs a fixed 4-iteration quaternion mean where JAX runs a 1e-12
tolerance loop), a 1000-tick trajectory to rtol 1e-6 / atol 1e-9, as in
test_torch_pose_fused.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_uwv_kalman_filters_tpu.models import pose_ukf as jpukf
from slam_uwv_kalman_filters_tpu.ops import ukf as jukf
from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as tf
from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as tu
from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
from slam_uwv_kalman_filters_tpu_torch.parallel.bank import tree_map

from torch_parity import DT, assert_tree_close, jx, mission_init, pt, random_bank, step_updates

STEP = dict(rtol=1e-8, atol=1e-10)
TRAJ = dict(rtol=1e-6, atol=1e-9)
NB, LANES = 5, 8


@pytest.fixture(scope="module")
def bank():
    state, params = mission_init()
    return random_bank(np.random.default_rng(90), state, NB), params


def _padded_lanes(bstate_np, lanes=LANES):
    """Port lanes state of the bank followed by pad lanes (copies of instance
    0, the JAX package's convention), NaN in the invalid half of the
    covariance: the step reads only cov_t[c, r ≥ c]."""
    bs = pt(bstate_np)
    pad = lanes - bs.cov.shape[0]
    ls = tf.to_lanes(tree_map(lambda a: torch.cat([a, a[:1].expand(pad, *a.shape[1:])]), bs))
    n = tf.TANGENT_DIM
    upper = torch.tril(torch.ones(n, n, dtype=torch.bool), -1)[..., None]
    return ls._replace(cov_t=torch.where(upper, float("nan"), ls.cov_t))


def _from_padded(ls, bstate_np):
    like = pt(bstate_np)
    wide = tree_map(lambda a: torch.cat([a, a[:1].expand(LANES - NB, *a.shape[1:])]), like)
    return tree_map(lambda a: a[:NB], tf.from_lanes(ls, wide))


def _chain(name, bstate, params, rng):
    """[(JAX bank update as fn(state) → (state, info), port StepUpdate)] for
    chain ``name``; measurements near each model's truth, instance 0 pushed
    out of the χ²-95 gate of the gated models."""
    p = jx(params)
    mu = jx(bstate.mu)
    p_atm = float(params.atmospheric_pressure)
    cw = 0.3
    specs = {
        "velocity": (jpukf._h_velocity, 0.03, None, (), lambda s, z, r: jpukf.update_velocity_bank(s, p, z, r)),
        "pressure": (lambda m: jpukf._h_pressure(p.atmospheric_pressure, jnp.zeros(3))(m), 50.0, None,
                     (p_atm, 0.0, 0.0, 0.0), lambda s, z, r: jpukf.update_pressure_bank(s, p, z, r)),
        "xy_position": (jpukf._h_xy_position, 0.7, jukf.D2P95, (),
                        lambda s, z, r: jpukf.update_xy_position_bank(s, p, z, r, jukf.D2P95)),
        "z_position": (jpukf._h_z_position, 0.1, None, (), lambda s, z, r: jpukf.update_z_position_bank(s, p, z, r)),
        "acceleration": (jpukf._h_acceleration, 0.006, None, (),
                         lambda s, z, r: jpukf.update_acceleration_bank(s, p, z, r)),
        "water_velocity": (jpukf._h_water_velocity(cw), 0.03, jukf.D2P95, (cw,),
                           lambda s, z, r: jpukf.update_water_velocity_bank(s, p, z, r, cw)),
    }
    models = {
        "acceleration": ["acceleration"],
        "six": ["velocity", "pressure", "xy_position", "z_position", "acceleration", "water_velocity"],
        "latency": ["acceleration", "velocity"],
    }[name]
    out = []
    for model in models:
        h, std, gate, aux, ref = specs[model]
        truth = np.asarray(jax.vmap(h)(mu))
        z = truth + rng.normal(0.0, std, truth.shape)
        if gate is not None:
            z[0] += 20.0  # instance 0 fails the gate
        r = np.eye(z.shape[1]) * std**2
        out.append((ref, jnp.asarray(z), jnp.asarray(r), tu.StepUpdate(model, torch.tensor(z), torch.tensor(r), gate, aux)))
    return out


@pytest.mark.parametrize("chain", ["acceleration", "six", "latency"])
def test_step_lanes_matches_jax_chain(bank, chain):
    bstate, params = bank
    ups = _chain(chain, bstate, params, np.random.default_rng(91))
    p = jx(params)

    def ref_chain(s):
        s = jpukf.predict_bank(s, p, DT)
        infos = []
        for ref, z, r, _ in ups:
            s, info = ref(s, z, r)
            infos.append(info)
        return s, infos

    ref_state, ref_infos = jax.jit(ref_chain)(jx(bstate))
    ls, infos = tu.step_lanes(_padded_lanes(bstate), pt(params), DT, [u[3] for u in ups])
    assert_tree_close(_from_padded(ls, bstate), ref_state, **STEP, what=chain)
    assert len(infos) == len(ups)
    for k, (got, want) in enumerate(zip(infos, ref_infos)):
        assert got.mahalanobis2.shape == (NB,)
        np.testing.assert_array_equal(got.accepted.numpy(), np.asarray(want.accepted))
        np.testing.assert_allclose(got.mahalanobis2.numpy(), np.asarray(want.mahalanobis2), **STEP, err_msg=str(k))
        np.testing.assert_allclose(got.innovation.numpy(), np.asarray(want.innovation), **STEP, err_msg=str(k))
        if ups[k][3].gate_threshold is not None:
            assert not bool(got.accepted[0]) and bool(got.accepted[1:].all())


def test_step_velocity_lanes_and_jax_step_updates(bank):
    """``step_velocity_lanes`` against JAX's predict + DVL chain; the JAX
    package's own StepUpdate list, carried over by the parity helper, gives
    the same step."""
    from slam_uwv_kalman_filters_tpu.models import pose_update_fused as jpuf

    bstate, params = bank
    (ref, z, r, u), = _chain("latency", bstate, params, np.random.default_rng(92))[1:]
    p = jx(params)
    ref_state, ref_info = jax.jit(lambda s: ref(jpukf.predict_bank(s, p, DT), z, r))(jx(bstate))
    ls, info = tu.step_velocity_lanes(tf.to_lanes(pt(bstate)), pt(params), DT, u.z, u.meas_cov)
    assert_tree_close(tf.from_lanes(ls, pt(bstate)), ref_state, **STEP)
    np.testing.assert_allclose(info.mahalanobis2.numpy(), np.asarray(ref_info.mahalanobis2), **STEP)
    jax_updates = [jpuf.StepUpdate("velocity", z, r), jpuf.StepUpdate("pressure", z[:, :1] + 1e5, r[:1, :1] * 1e6,
                                                                     None, (float(params.atmospheric_pressure),))]
    converted = step_updates(jax_updates, tu.StepUpdate)
    assert [type(c) for c in converted] == [tu.StepUpdate] * 2 and converted[1].aux == jax_updates[1].aux
    ls2, _ = tu.step_lanes(tf.to_lanes(pt(bstate)), pt(params), DT, converted[:1])
    assert torch.equal(ls2.cov_t, ls.cov_t) and torch.equal(ls2.mu_t, ls.mu_t)


def test_step_lanes_validates_inputs(bank):
    from torch_parity import banked_params

    bstate, params = bank
    ls, tp = tf.to_lanes(pt(bstate)), pt(params)
    acc = tu.StepUpdate("acceleration", torch.zeros(NB, 3, dtype=torch.float64), torch.eye(3))
    with pytest.raises(ValueError, match="at least one"):
        tu.step_lanes(ls, tp, DT, [])
    with pytest.raises(ValueError, match="inconsistent bank"):
        tu.step_lanes(ls, tp, DT, [acc, tu.StepUpdate("z_position", torch.zeros(NB - 1, 1), torch.eye(1))])
    with pytest.raises(ValueError, match="update_body_efforts_lanes"):
        tu.step_lanes(ls, tp, DT, [acc, tu.StepUpdate("body_efforts", torch.zeros(NB, 6), torch.eye(6))])
    with pytest.raises(ValueError, match="MAX_STEP_UPDATES"):
        tu.step_lanes(ls, tp, DT, [acc] * (tu.MAX_STEP_UPDATES + 1))
    bp = pt(banked_params(np.random.default_rng(93), params, NB))
    with pytest.raises(ValueError, match="predict_lanes"):
        tu.step_lanes(ls, bp, DT, [acc])
    # a cap-long chain is accepted
    _, infos = tu.step_lanes(ls, tp, DT, [acc] * tu.MAX_STEP_UPDATES)
    assert len(infos) == tu.MAX_STEP_UPDATES


@pytest.mark.parametrize("leaf", ["gyro_bias_tau", "water_density_offset", "process_noise", "projection.lat0"])
def test_shared_predict_refuses_a_banked_leaf(bank, leaf):
    """One banked leaf among shared ones: the shared-mode operands refuse it
    for step_lanes and for predict_lanes alike, naming the full mode."""
    bstate, params = bank
    tp = pt(params)
    group, _, name = leaf.rpartition(".")
    owner = getattr(tp, group) if group else tp
    banked = owner._replace(**{name: getattr(owner, name).expand(NB, *getattr(owner, name).shape)})
    bp = tp._replace(**{group: banked}) if group else banked
    ls = tf.to_lanes(pt(bstate))
    acc = tu.StepUpdate("acceleration", torch.zeros(NB, 3, dtype=torch.float64), torch.eye(3))
    with pytest.raises(ValueError, match="bank axis"):
        tu.step_lanes(ls, bp, DT, [acc])
    with pytest.raises(ValueError, match="bank"):
        tf.predict_lanes(ls, bp, DT)


def test_predict_operands_are_kept_until_their_inputs_change(bank):
    """The shared-mode operands of one parameter object and dt are built
    once; another dt or dtype, another object, or an in-place write to a
    leaf builds them anew."""
    _, params = bank
    tp = tree_map(torch.clone, pt(params))
    f64 = torch.float64
    first = tf._predict_operands_shared(tp, DT, f64)
    assert tf._predict_operands_shared(tp, DT, f64) is first
    assert tf._predict_operands_shared(tp, 2 * DT, f64)[3][0, 0] == 2 * DT
    assert tf._predict_operands_shared(tp, DT, torch.float32)[0].dtype == torch.float32
    other = tf._predict_operands_shared(tp._replace(), DT, f64)
    assert other is not first and all(torch.equal(a, b) for a, b in zip(other, first))
    tp.process_noise.mul_(2.0)
    scaled = tf._predict_operands_shared(tp, DT, f64)
    assert torch.equal(scaled[2], 2.0 * first[2])


def test_cpu_tensors_take_the_plain_route(bank):
    bstate, params = bank
    cuda_lib.reset_launch_counts()
    tu.step_velocity_lanes(tf.to_lanes(pt(bstate)), pt(params), DT, torch.zeros(NB, 3), torch.eye(3))
    assert all(k.launches == 0 for k in cuda_lib.KERNELS.values())


def test_stepped_trajectory_matches_the_chain():
    """1000 ticks of bench.py's stepped mission schedule at bank 2: one
    ``step_lanes`` per tick (acceleration, and that tick's DVL 5 Hz,
    pressure 2 Hz, χ²-gated ADCP 1 Hz), body efforts after it at 10 Hz,
    against the port's own predict_lanes + update_model_lanes chain. On the
    CPU both sides run the same plain bodies, so this holds what step_lanes
    adds around them over a long schedule — the chain's order, the aux and
    gate blocks, the measurement layout; K5 itself is held to the chain on
    the card (test_torch_cuda_kernels.py, chip_smoke.py's stepped second)."""
    state, params = mission_init()
    rng = np.random.default_rng(94)
    nb = 2
    bstate = jax.tree.map(lambda a: np.broadcast_to(a, (nb, *np.shape(a))).copy(), state)
    bstate = bstate._replace(
        mu=bstate.mu._replace(position=bstate.mu.position + rng.normal(0, 0.1, (nb, 3)),
                              velocity=bstate.mu.velocity + rng.normal(0, 0.1, (nb, 3))),
        rotation_rate=np.broadcast_to([0.0, 0.0, 0.01], (nb, 3)).copy(),
    )
    tp = pt(params)
    p_atm = tp.atmospheric_pressure
    g = 9.8209
    t = lambda a: torch.tensor(np.asarray(a, np.float64))
    meas = {
        "acc": (t(np.tile([0.0, 0.0, g], (nb, 1))), t(np.eye(3) * 4e-5)),
        "dvl": (t(np.tile([0.3, 0.0, 0.0], (nb, 1))), t(np.eye(3) * 1e-3)),
        "press": (torch.full((nb, 1), float(p_atm)), t(np.eye(1) * 2500.0)),
        "adcp": (t(np.zeros((nb, 2))), t(np.eye(2) * 1e-3)),
        "eff": (t(np.zeros((nb, 6))), t(np.eye(6))),
    }
    step = chain = tf.to_lanes(pt(bstate))
    for k in range(1000):
        ups = [tu.StepUpdate("acceleration", *meas["acc"])]
        chain = tf.predict_lanes(chain, tp, DT)
        chain, _ = tu.update_model_lanes("acceleration", chain, *meas["acc"])
        if k % 20 == 19:
            ups.append(tu.StepUpdate("velocity", *meas["dvl"]))
            chain, _ = tu.update_model_lanes("velocity", chain, *meas["dvl"])
        if k % 50 == 49:
            ups.append(tu.StepUpdate("pressure", *meas["press"], None, (p_atm, 0.0, 0.0, 0.0)))
            chain, _ = tu.update_model_lanes("pressure", chain, *meas["press"], aux=(p_atm, 0.0, 0.0, 0.0))
        if k % 100 == 99:
            ups.append(tu.StepUpdate("water_velocity", *meas["adcp"], jukf.D2P95, (0.5,)))
            chain, _ = tu.update_model_lanes("water_velocity", chain, *meas["adcp"], jukf.D2P95, aux=(0.5,))
        step, _ = tu.step_lanes(step, tp, DT, ups)
        if k % 10 == 9:
            step, _ = tu.update_body_efforts_lanes(step, tp, *meas["eff"])
            chain, _ = tu.update_body_efforts_lanes(chain, tp, *meas["eff"])
    out = tf.from_lanes(step, pt(bstate))
    assert torch.isfinite(out.cov).all()
    assert_tree_close(out, tf.from_lanes(chain, pt(bstate)), **TRAJ, what="trajectory")

"""Parity of the PyTorch port's VelocityUKF — the forward dynamics, the
generic filter (solo and bank, a banked-parameter sweep), the class wrapper
and the lanes path (the plain version of kernel K6, which a CPU tensor
takes) — with the JAX package at float64 on the CPU.

Tolerances: one step at rtol 1e-8 / atol 1e-10 and a 1000-step trajectory at
rtol 1e-6 / atol 1e-9, as the port's PoseUKF tests. The one float32
comparison, the plain K6 against the JAX kernel in Pallas interpret mode at
bank 128, is held to rtol 2e-5 / atol 2e-6: both round the same float32
arithmetic, the port's mean about the zero sigma point and the JAX kernel's
plain sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_uwv_kalman_filters_tpu.models import velocity_fused as jvf
from slam_uwv_kalman_filters_tpu.models import velocity_ukf as jv
from slam_uwv_kalman_filters_tpu.ops import dynamics as jdyn
from slam_uwv_kalman_filters_tpu.ops import ukf as jukf
from slam_uwv_kalman_filters_tpu_torch.models import velocity_fused as tvf
from slam_uwv_kalman_filters_tpu_torch.models import velocity_ukf as tv
from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
from slam_uwv_kalman_filters_tpu_torch.ops import dynamics as tdyn
from slam_uwv_kalman_filters_tpu_torch.parallel.bank import tree_map
from slam_uwv_kalman_filters_tpu_torch.utils.convert import from_numpy

from torch_parity import assert_tree_close, jx, np_tree, pt, step_updates

STEP = dict(rtol=1e-8, atol=1e-10)
TRAJ = dict(rtol=1e-6, atol=1e-9)
DT = 0.05
NB = 5


def _vehicle(rng=None):
    """The default vehicle, or with ``rng`` one whose restoring terms are
    live (weight ≠ buoyancy, separated COG/COB) and whose matrices couple
    the axes (symmetric positive definite inertia)."""
    m = np_tree(jdyn.default_uwv_parameters())
    if rng is None:
        return m
    a = rng.normal(0.0, 3.0, (6, 6))
    return m._replace(
        inertia_matrix=m.inertia_matrix + a @ a.T / 6,
        damping_linear=m.damping_linear + rng.normal(0.0, 2.0, (6, 6)),
        weight=np.asarray(1000.0), cog=np.array([0.01, -0.02, 0.05]), cob=np.array([0.0, 0.01, -0.03]),
    )


def _quats(rng, n):
    q = rng.normal(size=(n, 4)) * [1.0, 0.2, 0.2, 0.4] + [2.0, 0.0, 0.0, 0.0]
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def bank():
    """A bank of filters away from rest: moved means, correlated
    covariances, efforts, gyro rates and tracker orientations, on a coupled
    vehicle with live restoring terms."""
    rng = np.random.default_rng(100)
    mu = jv.VelocityState(velocity=jnp.zeros(3), z_position=jnp.zeros(1))
    state, params = jv.init(mu, jnp.eye(4) * 0.1, jdyn.default_uwv_parameters())
    bs = jax.tree.map(lambda a: np.broadcast_to(np.asarray(a), (NB, *np.shape(a))).copy(), state)
    g = rng.normal(size=(NB, 4, 4))
    av = rng.normal(0.0, 0.05, (NB, 3))
    bs = bs._replace(
        mu=bs.mu._replace(velocity=rng.normal(0.0, 0.5, (NB, 3)), z_position=rng.normal(0.0, 2.0, (NB, 1))),
        cov=0.02 * (g @ np.swapaxes(g, 1, 2) / 4 + np.eye(4)),
        body_efforts=rng.normal(0.0, 30.0, (NB, 6)),
        angular_velocity=av,
        model_state=bs.model_state._replace(
            position=rng.normal(size=(NB, 3)), orientation=_quats(rng, NB),
            linear_velocity=rng.normal(0.0, 0.5, (NB, 3)), angular_velocity=av,
        ),
    )
    return bs, np_tree(params)._replace(model=_vehicle(rng))


def test_forward_dynamics_match_jax():
    rng = np.random.default_rng(101)
    model = _vehicle(rng)
    n = 7
    vel, eff, q = rng.normal(0.0, 0.8, (n, 6)), rng.normal(0.0, 50.0, (n, 6)), _quats(rng, n)
    ref = jax.vmap(lambda e, v, qq: jdyn.calc_acceleration(jx(model), e, v, qq))(eff, vel, q)
    tm = pt(model)
    out = tdyn.calc_acceleration(tm, torch.tensor(eff), torch.tensor(vel), torch.tensor(q))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **STEP)
    # calc_efforts inverts it
    back = tdyn.calc_efforts(tm, out, torch.tensor(vel), torch.tensor(q))
    np.testing.assert_allclose(back.numpy(), eff, rtol=1e-10, atol=1e-9)
    st = jdyn.PoseVelocityState(position=rng.normal(size=(n, 3)), orientation=q, linear_velocity=vel[:, :3],
                                angular_velocity=vel[:, 3:])
    for integrate_pose in (True, False):
        ref = jax.vmap(lambda s, e: jdyn.simulate_effort(jx(model), s, e, DT, integrate_pose=integrate_pose))(
            jx(st), jnp.asarray(eff))
        out = tdyn.simulate_effort(tm, pt(st), torch.tensor(eff), DT, integrate_pose=integrate_pose)
        assert_tree_close(out, ref, **STEP, what=f"integrate_pose={integrate_pose}")


def _one(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


def test_solo_predict_and_updates_match_jax(bank):
    bs, params = bank
    s = _one(bs)
    rng = np.random.default_rng(102)
    z_dvl, r_dvl = rng.normal(0.0, 0.5, 3), np.eye(3) * 0.01
    z_p, r_p = rng.normal(0.0, 1.0, 1), np.eye(1) * 0.04
    ref = jv.predict(jx(s), jx(params), DT)
    out = tv.predict(pt(s), pt(params), DT)
    assert_tree_close(out, ref, **STEP, what="predict")
    ref_d, ref_di = jv.update_dvl(ref, jnp.asarray(z_dvl), jnp.asarray(r_dvl))
    out_d, out_di = tv.update_dvl(out, torch.tensor(z_dvl), torch.tensor(r_dvl))
    assert_tree_close(out_d, ref_d, **STEP, what="dvl")
    np.testing.assert_allclose(out_di.mahalanobis2.numpy(), np.asarray(ref_di.mahalanobis2), **STEP)
    ref_p, _ = jv.update_pressure(ref_d, jnp.asarray(z_p), jnp.asarray(r_p))
    out_p, _ = tv.update_pressure(out_d, torch.tensor(z_p), torch.tensor(r_p))
    assert_tree_close(out_p, ref_p, **STEP, what="pressure")


def test_bank_paths_match_jax(bank):
    """The bank API (generic path on the CPU), with shared parameters and
    with a banked sweep of the vehicle model and process noise."""
    bs, params = bank
    rng = np.random.default_rng(103)
    z, r = rng.normal(0.0, 0.5, (NB, 3)), np.eye(3) * 0.01
    zp, rp = rng.normal(0.0, 1.0, (NB, 1)), np.eye(1) * 0.04
    scale = 1.0 + 0.2 * rng.uniform(-1.0, 1.0, NB)
    sweeps = {
        "shared": params,
        "banked": params._replace(
            process_noise=params.process_noise[None] * scale[:, None, None],
            model=params.model._replace(inertia_matrix=params.model.inertia_matrix[None] * scale[:, None, None],
                                        weight=params.model.weight * scale),
        ),
    }
    for name, p in sweeps.items():
        ref = jax.jit(lambda s, pp: jv.predict_bank(s, pp, DT, use_fused=False))(jx(bs), jx(p))
        out = tv.predict_bank(pt(bs), pt(p), DT)
        assert_tree_close(out, ref, **STEP, what=f"predict_bank {name}")
    ref_d, ref_di = jv.update_dvl_bank(ref, jnp.asarray(z), jnp.asarray(r), use_fused=False)
    out_d, out_di = tv.update_dvl_bank(out, torch.tensor(z), torch.tensor(r))
    assert_tree_close(out_d, ref_d, **STEP, what="update_dvl_bank")
    np.testing.assert_allclose(out_di.innovation.numpy(), np.asarray(ref_di.innovation), **STEP)
    ref_p, _ = jv.update_pressure_bank(ref_d, jnp.asarray(zp), jnp.asarray(rp), use_fused=False)
    out_p, _ = tv.update_pressure_bank(out_d, torch.tensor(zp), torch.tensor(rp))
    assert_tree_close(out_p, ref_p, **STEP, what="update_pressure_bank")


def test_class_wrapper(bank):
    bs, params = bank
    s = pt(_one(bs))
    f = tv.VelocityUKF(s.mu, s.cov)
    with pytest.raises(RuntimeError, match="Motion model is not initialized"):
        f.prediction_step(DT)
    with pytest.raises(RuntimeError, match="Motion model is not initialized"):
        f.set_process_noise_covariance(torch.eye(4))
    assert f.setup_motion_model(pt(params.model))
    assert torch.equal(f.state.model_state.linear_velocity, s.mu.velocity)
    f.integrate_body_efforts(s.body_efforts)
    f64 = dict(dtype=torch.float64)
    f.integrate_gyro_measurement(s.angular_velocity, torch.eye(3, **f64) * 1e-6)
    with pytest.raises(ValueError, match="NaN"):
        f.integrate_dvl_measurement(torch.tensor([float("nan"), 0.0, 0.0]), torch.eye(3))
    with pytest.raises(ValueError, match="negative"):
        f.integrate_pressure_measurement(torch.zeros(1), -torch.eye(1))
    f.prediction_step(DT)
    info = f.integrate_dvl_measurement(torch.tensor([0.3, 0.0, 0.0], **f64), torch.eye(3, **f64) * 0.01)
    ref = jv.VelocityUKF(jx(_one(bs).mu), jnp.asarray(_one(bs).cov))
    ref.setup_motion_model(jx(params.model))
    ref.integrate_body_efforts(jnp.asarray(_one(bs).body_efforts))
    ref.integrate_gyro_measurement(jnp.asarray(_one(bs).angular_velocity))
    ref.prediction_step(DT)
    ref_info = ref.integrate_dvl_measurement(jnp.array([0.3, 0.0, 0.0]), jnp.eye(3) * 0.01)
    assert_tree_close(f.state, ref.state, **STEP)
    np.testing.assert_allclose(float(info.mahalanobis2), float(ref_info.mahalanobis2), **STEP)
    assert_tree_close(f.mu, ref.mu, **STEP)


def _gated_updates(bs, rng):
    """DVL near the predicted truth with instance 0 pushed out of its χ²-95
    gate, then pressure-derived depth, accept-any."""
    z = bs.mu.velocity + rng.normal(0.0, 0.05, (NB, 3))
    z[0] += 3.0
    zp = bs.mu.z_position + rng.normal(0.0, 0.2, (NB, 1))
    return [("dvl", z, np.eye(3) * 0.01, 7.815), ("pressure", zp, np.eye(1) * 0.04, None)]


def test_lanes_step_matches_jax_generic(bank):
    """The plain K6 (predict + [dvl, pressure], a gate that rejects instance
    0) against the JAX generic vmap path, and the JAX StepUpdate list carried
    over to the port's."""
    bs, params = bank
    ups = _gated_updates(bs, np.random.default_rng(104))
    p = jx(params)

    def ref_step(s):
        s = jv.predict_bank(s, p, DT, use_fused=False)
        infos = []
        for model, z, r, thr in ups:
            h = (lambda x: x.velocity) if model == "dvl" else (lambda x: x.z_position)
            mu, cov, info = jax.vmap(lambda m, c, zz: jukf.update(jv.VELOCITY_MANIFOLD, m, c, zz, h, jnp.asarray(r),
                                                                  gate_threshold=thr))(s.mu, s.cov, jnp.asarray(z))
            s = s._replace(mu=mu, cov=cov)
            infos.append(info)
        return s, infos

    ref_state, ref_infos = jax.jit(ref_step)(jx(bs))
    jax_updates = [jvf.StepUpdate(m, jnp.asarray(z), jnp.asarray(r), thr) for m, z, r, thr in ups]
    lanes = tvf.to_lanes(pt(bs), lanes=8)  # three pad lanes
    ls, infos = tvf.step_lanes(lanes, pt(params), DT, step_updates(jax_updates, tvf.StepUpdate))
    assert_tree_close(tvf.from_lanes(ls, pt(bs)), ref_state, **STEP)
    assert torch.isfinite(ls.cov_t).all() and torch.isfinite(ls.trk_t).all()
    for got, want in zip(infos, ref_infos):
        np.testing.assert_array_equal(got.accepted.numpy(), np.asarray(want.accepted))
        np.testing.assert_allclose(got.mahalanobis2.numpy(), np.asarray(want.mahalanobis2), **STEP)
        np.testing.assert_allclose(got.innovation.numpy(), np.asarray(want.innovation), **STEP)
    assert infos[0].accepted.tolist() == [False] + [True] * (NB - 1)
    # the bank entries and the split predict / update forms give the same
    split = tvf.predict_lanes(lanes, pt(params), DT, nb=NB)
    for model, z, r, thr in ups:
        split, _ = tvf.update_model_lanes(model, split, torch.tensor(z), torch.tensor(r), thr)
    assert_tree_close(tvf.from_lanes(split, pt(bs)), ref_state, **STEP, what="split")


def test_lanes_step_matches_jax_kernel_float32(bank):
    """The plain K6 at float32 against the JAX kernel (Pallas interpret
    mode) at bank 128: the lanes layout, the parameter block and the
    tracker's kinematic step."""
    bs, params = bank
    big = jax.tree.map(lambda a: np.concatenate([a] * 26)[:128].astype(np.float32), bs)
    p32 = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    rng = np.random.default_rng(105)
    z = (big.mu.velocity + rng.normal(0.0, 0.05, (128, 3))).astype(np.float32)
    r = np.eye(3, dtype=np.float32) * 0.01
    ref_ls, ref_infos = jvf.step_lanes(jvf.to_lanes(jx(big)), jx(p32), DT, [jvf.StepUpdate("dvl", jnp.asarray(z), r)],
                                       interpret=True)
    t32 = lambda tree: from_numpy(tree, device="cpu", dtype=torch.float32)
    ls, infos = tvf.step_lanes(tvf.to_lanes(t32(big)), t32(p32), DT,
                               [tvf.StepUpdate("dvl", torch.tensor(z), torch.tensor(r))])
    tol = dict(rtol=2e-5, atol=2e-6)
    for name in ("cov_t", "mu_t", "trk_t"):
        np.testing.assert_allclose(getattr(ls, name).numpy(), np.asarray(getattr(ref_ls, name)), **tol, err_msg=name)
    np.testing.assert_allclose(infos[0].mahalanobis2.numpy(), np.asarray(ref_infos[0].mahalanobis2), rtol=1e-4)


def test_lanes_trajectory_matches_generic(bank):
    """1000 steps (predict + DVL every step, pressure every 5th, fresh
    efforts and gyro every 10th) of the lanes path against the generic bank
    path, both the port's."""
    bs, params = bank
    rng = np.random.default_rng(106)
    tp = pt(params)
    gen = pt(bs)
    ls = tvf.to_lanes(gen)
    r, rp = torch.eye(3, dtype=torch.float64) * 0.01, torch.eye(1, dtype=torch.float64) * 0.04
    for k in range(1000):
        if k % 10 == 0:
            eff, av = torch.tensor(rng.normal(0.0, 20.0, (NB, 6))), torch.tensor(rng.normal(0.0, 0.02, (NB, 3)))
            gen = tv.integrate_gyro(tv.integrate_body_efforts(gen, eff), av)
            ls = tvf.set_inputs_lanes(ls, body_efforts=eff, angular_velocity=av)
        z = torch.tensor(rng.normal(0.3, 0.05, (NB, 3)))
        ups = [tvf.StepUpdate("dvl", z, r)]
        gen = tv.predict_bank(gen, tp, DT)
        gen, _ = tv.update_dvl_bank(gen, z, r)
        if k % 5 == 4:
            zp = torch.tensor(rng.normal(-2.0, 0.2, (NB, 1)))
            ups.append(tvf.StepUpdate("pressure", zp, rp))
            gen, _ = tv.update_pressure_bank(gen, zp, rp)
        ls, _ = tvf.step_lanes(ls, tp, DT, ups)
    out = tvf.from_lanes(ls, gen)
    assert torch.isfinite(out.cov).all()
    assert_tree_close(out, gen, **TRAJ, what="trajectory")


def test_params_block_is_kept_until_its_inputs_change(bank):
    _, params = bank
    tp = tree_map(lambda a: a.clone() if isinstance(a, torch.Tensor) else a, pt(params))
    first = tvf.params_block(tp, DT, torch.float64)
    assert tvf.params_block(tp, DT, torch.float64) is first
    assert float(tvf.params_block(tp, 2 * DT, torch.float64)[0, 0]) == 2 * DT
    tp.model.damping_linear.mul_(2.0)
    damped = tvf.params_block(tp, DT, torch.float64)
    assert torch.equal(damped[73:109], 2.0 * first[73:109]) and torch.equal(damped[:73], first[:73])


def test_cpu_tensors_take_the_plain_route(bank):
    bs, params = bank
    cuda_lib.reset_launch_counts()
    tvf.predict_fused_banked(pt(bs), pt(params), DT)
    tvf.update_model_fused_banked("pressure", pt(bs), torch.zeros(NB, 1), torch.eye(1))
    assert all(k.launches == 0 for k in cuda_lib.KERNELS.values())
    with pytest.raises(ValueError, match="MAX_STEP_UPDATES"):
        tvf.step_lanes(tvf.to_lanes(pt(bs)), pt(params), DT,
                       [tvf.StepUpdate("pressure", torch.zeros(NB, 1), torch.eye(1))] * (tvf.MAX_STEP_UPDATES + 1))

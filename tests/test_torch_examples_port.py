"""The port's four remaining examples
(``slam_uwv_kalman_filters_tpu_torch/examples/``: ``online_estimator``,
``icra18_mission``, ``noise_tuning_sweep``, ``full_stack_auv``) on the CPU at
tiny sizes: each one's ``--help``; a ``--cpu`` run that passes the example's
own checks; its refusal to fall back to the CPU without ``--cpu`` on a
machine without a card; the online estimator's ``--aot`` run equal to its
live run bit for bit; and a short stretch of each, float64, against the JAX
package's generic functions composed as the JAX example composes them (the
sweep's parameter axis as ``jax.vmap`` of them), to rtol 1e-10 and atol
1e-10 (the BottomUKF's S² means stop at a correction of 1e-12 in either
package, and its normal moves by a few 1e-11 with them).
"""

import runpy
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_uwv_kalman_filters_tpu.models import bottom_ukf as jbukf
from slam_uwv_kalman_filters_tpu.models import indirect_pose_ukf as jiukf
from slam_uwv_kalman_filters_tpu.models import pose_driver as jdrv
from slam_uwv_kalman_filters_tpu.models import pose_ukf as jpukf
from slam_uwv_kalman_filters_tpu.models import velocity_ukf as jvukf
from slam_uwv_kalman_filters_tpu.ops import dynamics as jdyn
from slam_uwv_kalman_filters_tpu.parallel import bank as jbank
from slam_uwv_kalman_filters_tpu.utils.config import CameraConfiguration as JCamera
from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config as jconfig
from slam_uwv_kalman_filters_tpu_torch import runtime
from slam_uwv_kalman_filters_tpu_torch.examples import full_stack_auv as fs
from slam_uwv_kalman_filters_tpu_torch.examples import icra18_mission as icra
from slam_uwv_kalman_filters_tpu_torch.examples import noise_tuning_sweep as sweep
from slam_uwv_kalman_filters_tpu_torch.examples import online_estimator as oe
from slam_uwv_kalman_filters_tpu_torch.models import pose_fused

from torch_parity import assert_tree_close

TOL = dict(rtol=1e-10, atol=1e-10)
EXAMPLES = {"online_estimator": oe, "icra18_mission": icra, "noise_tuning_sweep": sweep, "full_stack_auv": fs}
CPU_RUNS = {
    "online_estimator": ["--cpu", "--bank", "2", "--seconds", "2", "--rate", "25", "--fused-step"],
    "icra18_mission": ["--cpu", "--minutes", "0.02", "--rate", "50"],
    "noise_tuning_sweep": ["--cpu", "--candidates", "4", "--seconds", "2"],
    "full_stack_auv": ["--cpu", "--seconds", "5.2", "--rate", "25"],
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_help(name, monkeypatch, capsys):
    """``python -m …examples.<name> --help``, run in this process."""
    monkeypatch.setattr(sys, "argv", [name, "--help"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the module is imported already
        with pytest.raises(SystemExit) as done:
            runpy.run_module(f"slam_uwv_kalman_filters_tpu_torch.examples.{name}", run_name="__main__")
    assert done.value.code == 0
    assert "--cpu" in capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_cpu_run_passes_the_examples_checks(name):
    figures = EXAMPLES[name].main(CPU_RUNS[name])
    assert figures["device"] == "cpu"


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_without_a_card_and_without_cpu_it_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EXAMPLES[name].main([a for a in CPU_RUNS[name] if a != "--cpu"])


def test_online_estimator_aot_equals_live():
    argv = ["--cpu", "--bank", "2", "--seconds", "2", "--rate", "25", "--fused-step"]
    live, exported = oe.main(argv), oe.main(argv + ["--aot"])
    assert exported["artifact_bytes"] > 0 and exported["export_s"] > 0
    for a, b in zip(live["lanes"], exported["lanes"]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# short stretches against the JAX package's generic functions
# ---------------------------------------------------------------------------


def _jax_pose(pos, quat, rate):
    return jpukf.init_from_pose(
        imu_in_nwu_pos=jnp.asarray(pos), imu_in_nwu_pos_cov=jnp.eye(3) * 0.25, imu_in_nwu_rot=jnp.asarray(quat),
        imu_in_nwu_rot_cov=jnp.eye(3) * 1e-4, config=jconfig(), model_parameters=jdyn.default_uwv_parameters(),
        imu_delta_t=1.0 / rate,
    )


def test_online_estimator_stretch_equals_jax():
    nb, rate, seconds = 2, 25.0, 2
    dt = 1.0 / rate
    like, params, ls = oe.estimator_setup(nb, rate, "cpu", torch.float64)
    ticks = oe.tick_functions(params, dt)
    jstate, jparams = _jax_pose([0.0, 0.0, oe.DEPTH], [1.0, 0, 0, 0], rate)
    bs = jbank.replicate(jpukf.integrate_rotation_rate(jstate, jnp.zeros(3)), nb)
    predict, dvl = jax.jit(jpukf.predict_bank), jax.jit(jpukf.update_velocity_bank)
    press = jax.jit(jpukf.update_pressure_bank)
    rng = np.random.default_rng(0)
    packer = runtime.StreamPacker(np.asarray([3, 3, 1], np.int32), t0_us=0, dt_us=int(1e6 / rate),
                                  window_ticks=int(rate), payload_stride=6)
    last = np.zeros(3)
    cfg = jconfig()
    rho, p_atm = float(cfg.hydrostatics.water_density), float(cfg.hydrostatics.atmospheric_pressure)
    for sec in range(seconds):
        packer.push(*oe.make_event_chunk(rng, int(sec * 1e6), 1.0, rate, np.array(oe.TRUE_VELOCITY), oe.DEPTH, oe.G,
                                         rho, p_atm))
        _, values, valid = packer.pop(force=True)
        gyro, _ = runtime.forward_fill(values[oe.GYRO], valid[oe.GYRO], last)
        last = gyro[-1, :3].copy()
        ls = oe.run_window(ticks, ls, values, valid, gyro, fused_step=True)
        for k in range(values.shape[1]):
            bs = predict(bs._replace(rotation_rate=jnp.tile(gyro[k, :3], (nb, 1))), jparams, dt)
            if valid[oe.DVL, k]:
                bs, _ = dvl(bs, jparams, jnp.tile(values[oe.DVL, k, :3], (nb, 1)), jnp.eye(3) * 1e-4)
            if valid[oe.PRESS, k]:
                bs, _ = press(bs, jparams, jnp.tile(values[oe.PRESS, k, :1], (nb, 1)), jnp.eye(1) * 2500.0)
    assert_tree_close(pose_fused.from_lanes(ls, like), bs, **TOL, what="online estimator")


def test_icra18_stretch_equals_jax():
    sim, state, params, inputs = icra.mission_setup(1.0 / 60.0, 50.0, 0, None, "cpu", torch.float64)
    outs = icra.replay(state, params, inputs, lanes=False)
    jstate, jparams = _jax_pose(sim["pos"][0], sim["quat"][0], 50.0)
    n = inputs.dt.shape[0]
    every = lambda hz: (np.arange(n) % max(1, int(round(50.0 / hz)))) == 0
    rng = np.random.default_rng(0)
    from slam_uwv_kalman_filters_tpu_torch.models.fleet_setup import simulate_mission
    simulate_mission(n, 1.0 / 50.0, rng)  # the draws of the mission before the fixes'
    xy = sim["pos"][:, :2] + rng.normal(scale=1.5, size=(n, 2))
    jinputs = jdrv.make_inputs(
        n, 1.0 / 50.0, rotation_rate=sim["gyro"],
        acc=sim["acc"], acc_cov=np.eye(3) * (2e-3) ** 2 * 4, acc_valid=every(100.0),
        dvl=sim["dvl"], dvl_cov=np.eye(3) * (2e-3) ** 2 * 4, dvl_valid=every(5.0),
        pressure=sim["pressure"], pressure_cov=np.eye(1) * 50.0**2 * 4, pressure_valid=every(10.0),
        xy=xy, xy_cov=np.eye(2) * 1.5**2 * 4, xy_valid=every(1.0 / 30.0),
    )
    _, jouts = jax.jit(jdrv.run_trajectory)(jstate, jparams, jinputs)
    np.testing.assert_allclose(outs.position.numpy(), np.asarray(jouts.position), **TOL)
    np.testing.assert_allclose(outs.orientation.numpy(), np.asarray(jouts.orientation), **TOL)


def test_noise_sweep_stretch_equals_jax_vmap_of_the_generic_functions():
    candidates, seconds, rate = 4, 1.0, 25.0
    scales, params_bank, ls, dvl, r_dvl = sweep.sweep_setup(candidates, seconds, rate, 0, "cpu", torch.float64)
    mean_nis = sweep.sweep(ls, params_bank, dvl, r_dvl, 1.0 / rate)
    jstate, jparams = _jax_pose([0.0, 0.0, 0.0], [1.0, 0, 0, 0], rate)
    acc = jpukf.POSE_MANIFOLD.block("acceleration")
    mask = jnp.zeros((53, 53)).at[acc, acc].set(1.0)
    jbank_params = jax.vmap(lambda s: jparams._replace(process_noise=jparams.process_noise * (1.0 + (s - 1.0) * mask)))(
        jnp.asarray(scales.numpy()))
    s0 = jpukf.integrate_rotation_rate(jstate, jnp.zeros(3))

    def tick(s, p, z):
        s = jpukf.predict(s, p, 1.0 / rate)
        s, info = jpukf.update_velocity(s, p, z, jnp.asarray(r_dvl.numpy()))
        return s, info.mahalanobis2

    step = jax.jit(jax.vmap(tick, in_axes=(0, 0, None)))
    bs, nis = jbank.replicate(s0, candidates), []
    for z in np.asarray(dvl.numpy()):
        bs, m2 = step(bs, jbank_params, jnp.asarray(z))
        nis.append(m2)
    np.testing.assert_allclose(mean_nis.numpy(), np.mean(np.stack(nis), axis=0), rtol=1e-10)


def test_full_stack_stretch_equals_jax():
    seconds, rate = 5.0, 10.0
    (vel, bot, pose, ind), _ = fs.dive(seconds, rate, 0, "cpu", torch.float64)
    dt, n = 1.0 / rate, int(seconds * rate)
    rng = np.random.default_rng(0)
    model = jdyn.default_uwv_parameters()
    vs, vparams = jvukf.init(jvukf.VelocityState(velocity=jnp.zeros(3), z_position=jnp.asarray([fs.TRUE_DEPTH])),
                             jnp.eye(4) * 0.1, model)
    bs, bparams = jbukf.init(jbukf.BottomState(distance=jnp.asarray([fs.SEAFLOOR_D0 + 1.0]),
                                               normal=jnp.asarray([0.0, 0.0, 1.0])), jnp.diag(jnp.asarray([4.0, 0.05, 0.05])))
    ps, pparams = _jax_pose([0.0, 0.0, fs.TRUE_DEPTH], [1.0, 0, 0, 0], rate)
    ins, iparams = jiukf.init(position_error_std=jnp.full(3, 1e-3), orientation_error_std=jnp.full(3, 1e-4),
                              orientation_error_tau=60.0)
    s, c = np.sin(np.pi / 6), np.cos(np.pi / 6)
    beams = jnp.asarray([[s, 0, -c], [-s, 0, -c], [0, s, -c], [0, -s, -c]])
    normal = np.array([0.05, 0.0, 1.0]) / np.linalg.norm([0.05, 0.0, 1.0])
    cfg = jconfig()
    rho, p_atm = float(cfg.hydrostatics.water_density), float(cfg.hydrostatics.atmospheric_pressure)

    @jax.jit
    def velocity_tick(vs, gyro, efforts, dvl, depth, do_dvl):
        vs = jvukf.integrate_body_efforts(jvukf.integrate_gyro(vs, gyro), efforts)
        vs = jvukf.predict(vs, vparams, dt)
        vs2, _ = jvukf.update_dvl(vs, dvl, jnp.eye(3) * 1e-4)
        vs = jax.tree_util.tree_map(lambda a, b: jnp.where(do_dvl, a, b), vs2, vs)
        return jvukf.update_pressure(vs, depth, jnp.eye(1) * 1e-3)[0]

    @jax.jit
    def bottom_tick(bs, velocity, ranges, do_ranges):
        bs = jbukf.predict(jbukf.set_velocity(bs, velocity), bparams, dt)
        bs2 = bs
        for k in range(4):
            bs2, _ = jbukf.update_range(bs2, ranges[k:k + 1], jnp.eye(1) * 1e-2, beams[k], jnp.zeros(3))
        return jax.tree_util.tree_map(lambda a, b: jnp.where(do_ranges, a, b), bs2, bs)

    @jax.jit
    def pose_tick(ps, gyro, acc, dvl, pressure, efforts, do_dvl):
        ps = jpukf.predict(jpukf.integrate_rotation_rate(ps, gyro), pparams, dt)
        ps, _ = jpukf.update_acceleration(ps, pparams, acc, jnp.eye(3) * 1e-4)
        ps2, _ = jpukf.update_velocity(ps, pparams, dvl, jnp.eye(3) * 1e-4)
        ps = jax.tree_util.tree_map(lambda a, b: jnp.where(do_dvl, a, b), ps2, ps)
        ps, _ = jpukf.update_pressure(ps, pparams, pressure, jnp.eye(1) * 2500.0)
        return jpukf.update_body_efforts(ps, pparams, efforts, jnp.eye(6) * 1e-1)[0]

    from slam_uwv_kalman_filters_tpu.ops import manifolds as jmf
    ticks = fs.StackTicks(None, None, None, None, dt, "cpu", torch.float64)

    @jax.jit
    def marker_tick(ins, position, orientation, pixels, marker_p):
        ins = jiukf.update_pose_reference(jiukf.predict(ins, iparams, 5.0), position, orientation)
        return jiukf.update_markers(
            ins, pixels, jnp.tile(jnp.eye(2)[None] * 0.25, (4, 1, 1)), jnp.asarray(ticks.feature_pos), marker_p,
            jnp.asarray([1.0, 0, 0, 0]), jnp.eye(6) * 1e-6, JCamera(), jnp.zeros(3),
            jnp.asarray([0.0, 1.0, 0.0, 0.0]))[0]

    v_true = pos_x = 0.0
    denom = -(np.asarray(beams) @ normal)
    for k in range(n):
        v_true += dt * (65.0 - 40.0 * v_true - 25.0 * v_true**2) / 145.4
        pos_x += dt * v_true
        dist_true = fs.SEAFLOOR_D0 - pos_x * normal[0] / normal[2]
        gyro = jnp.asarray(rng.normal(scale=1e-4, size=3))
        acc = jnp.asarray([0, 0, fs.G] + rng.normal(scale=1e-3, size=3))
        dvl = jnp.asarray([v_true, 0, 0] + rng.normal(scale=2e-3, size=3))
        depth = jnp.asarray([fs.TRUE_DEPTH + rng.normal(scale=0.02)])
        pressure = jnp.asarray([p_atm - fs.TRUE_DEPTH * fs.G * rho + rng.normal(scale=50.0)])
        efforts = jnp.asarray(fs.SURGE_EFFORT + rng.normal(scale=0.5, size=6))
        ranges = jnp.asarray(dist_true / denom + rng.normal(scale=0.05, size=4))
        do_dvl = jnp.asarray(k % 10 == 0)
        vs = velocity_tick(vs, gyro, efforts, dvl, depth, do_dvl)
        bs = bottom_tick(bs, jmf.quat_rotate(ps.mu.orientation, vs.mu.velocity), ranges, do_dvl)
        ps = pose_tick(ps, gyro, acc, dvl, pressure, efforts, do_dvl)
        if (k + 1) % int(5.0 * rate) == 0:
            marker_p = np.array([pos_x, 0.0, fs.TRUE_DEPTH - 6.0])
            pixels = ticks.project_marker(torch.tensor([1.0, 0, 0, 0], dtype=torch.float64),
                                          torch.tensor([pos_x, 0.0, fs.TRUE_DEPTH], dtype=torch.float64),
                                          torch.as_tensor(marker_p))
            pixels += rng.normal(scale=0.5, size=pixels.shape)
            ins = marker_tick(ins, ps.mu.position, ps.mu.orientation, jnp.asarray(pixels), jnp.asarray(marker_p))
    for port, ref, what in ((vel, vs, "VelocityUKF"), (bot, bs, "BottomUKF"), (pose, ps, "PoseUKF"),
                            (ind, ins, "IndirectPoseUKF")):
        assert_tree_close(port, ref, **TOL, what=what)


def test_count_tick_flops_counts_and_measure_mxu_refuses_the_cpu():
    from slam_uwv_kalman_filters_tpu_torch.tools import roofline

    assert roofline.count_tick_flops(bank=1) > 0
    with pytest.raises(ValueError, match="measures a CUDA device"):
        roofline.measure_mxu(device="cpu")

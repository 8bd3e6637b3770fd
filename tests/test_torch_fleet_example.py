"""The port's fleet Monte-Carlo example
(``slam_uwv_kalman_filters_tpu_torch/examples/fleet_monte_carlo.py``) on the
CPU: ``--help``; a whole run at ``--cpu --bank 8 --seconds 1 --rate 2`` with
the example's own checks; its refusal to fall back to the CPU without
``--cpu`` on a machine without a card; and one simulated second (10 ticks,
the DVL every second tick) plus the heal, float64 at bank 8, against the
JAX package's own pure functions composed as ``examples/fleet_monte_carlo.py``
composes them (``pose_ukf.predict_bank``, ``update_velocity_bank``,
``failover.self_healing_step``, ``metrics.nees``), to 1e-10.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_uwv_kalman_filters_tpu.models import pose_ukf as jpukf
from slam_uwv_kalman_filters_tpu.ops import dynamics as jdyn
from slam_uwv_kalman_filters_tpu.parallel import bank as jbank
from slam_uwv_kalman_filters_tpu.parallel import failover as jfo
from slam_uwv_kalman_filters_tpu.utils import metrics as jm
from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config
from slam_uwv_kalman_filters_tpu_torch.examples import fleet_monte_carlo as fleet
from slam_uwv_kalman_filters_tpu_torch.parallel import failover

from torch_parity import assert_tree_close

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-10, atol=1e-12)
BANK, RATE, SEED = 8, 10.0, 3


def test_help():
    out = subprocess.run([sys.executable, "-m", "slam_uwv_kalman_filters_tpu_torch.examples.fleet_monte_carlo",
                          "--help"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-500:]
    assert "--bank" in out.stdout and "--cpu" in out.stdout


def test_runs_on_the_cpu_at_low_rate():
    figures = fleet.main(["--cpu", "--bank", "8", "--seconds", "1", "--rate", "2"])
    assert figures["device"] == "cpu" and figures["ranks"] == 1 and figures["seconds"] == 1
    assert figures["worst_velocity_error"] < 0.05
    assert figures["n_poisoned"] == figures["n_reseeded"] == 1 and figures["healthy_after_heal"]
    assert np.isfinite(figures["position_nees"]) and figures["filter_steps_per_s"] > 0


def test_without_a_card_and_without_cpu_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.main(["--bank", "8", "--seconds", "1", "--rate", "2"])


def jax_fleet_setup(bank, rate, seed):
    """``examples/fleet_monte_carlo.py``'s setup, in float64."""
    state, params = jpukf.init_from_pose(
        imu_in_nwu_pos=jnp.zeros(3), imu_in_nwu_pos_cov=jnp.eye(3) * 0.25,
        imu_in_nwu_rot=jnp.array([1.0, 0.0, 0.0, 0.0]), imu_in_nwu_rot_cov=jnp.eye(3) * 1e-4,
        config=default_pose_ukf_config(), model_parameters=jdyn.default_uwv_parameters(),
        imu_delta_t=1.0 / rate,
    )
    state = jpukf.integrate_rotation_rate(state, jnp.zeros(3))
    rng = np.random.default_rng(seed)
    bstate = jbank.replicate(state, bank)
    pos_err = jnp.asarray(rng.normal(scale=0.5, size=(bank, 3)))
    return bstate._replace(mu=bstate.mu._replace(position=bstate.mu.position + pos_err)), params, rng


def test_one_second_and_the_heal_equal_jax():
    dt, n_ticks, dvl_every = 1.0 / RATE, int(RATE), max(1, round(RATE / 5))
    jb, jparams, jrng = jax_fleet_setup(BANK, RATE, SEED)
    tb, tparams, trng = fleet.fleet_setup(BANK, RATE, SEED, "cpu", torch.float64)
    assert_tree_close(tb, jb, rtol=1e-12, atol=1e-15, what="setup")
    assert_tree_close(tparams, jparams, rtol=1e-12, atol=1e-15, what="params")

    true_v = np.array(fleet.TRUE_VELOCITY)
    z = np.tile(true_v, (BANK, 1))
    r = np.eye(3) * fleet.DVL_VAR
    predict, update = jax.jit(jpukf.predict_bank), jax.jit(jpukf.update_velocity_bank)
    for k in range(n_ticks):
        jb = predict(jb, jparams, dt)
        if k % dvl_every == 0:
            jb, _ = update(jb, jparams, z, r)
    truth = true_v * 1.0
    jstats = (jb.mu.position.mean(axis=0), jb.mu.position.std(axis=0).max(),
              jax.vmap(jm.nees)(jb.mu.position - truth[None], jb.cov[:, :3, :3]).mean())
    tz, tr = torch.as_tensor(z), torch.as_tensor(r)
    tb, tstats = fleet.second_of_steps(tb, tparams, tz, torch.as_tensor(truth), dt=dt, n_ticks=n_ticks,
                                       dvl_every=dvl_every, meas_cov=tr)
    assert_tree_close(tb, jb, **TOL, what="after one second")
    for got, ref in zip(tstats, jstats):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10)

    # the heal: the same instances poisoned in both, restarted from the bank itself
    tpoisoned, dead_idx = fleet.poison(tb, trng)
    assert sorted(dead_idx) == sorted(jrng.choice(BANK, size=1, replace=False))
    vel = np.asarray(jb.mu.velocity).copy()
    vel[dead_idx, 0] = np.nan
    jpoisoned = jb._replace(mu=jb.mu._replace(velocity=jnp.asarray(vel)))
    jheal = jfo.self_healing_step(lambda bs, zz: update(predict(bs, jparams, dt), jparams, zz, r))
    jhealed, jinfo, _ = jheal(jpoisoned, jb, z)
    healed, info, _ = failover.self_healing_step(fleet.bank_step(tparams, dt, tr))(tpoisoned, tb, tz)
    np.testing.assert_array_equal(info.healthy.numpy(), np.asarray(jinfo.healthy))
    assert int(info.n_reseeded) == int(jinfo.n_reseeded) == len(dead_idx) == 1
    assert_tree_close(healed, jhealed, **TOL, what="healed")
    assert torch.equal(healed.cov[dead_idx[0]], tb.cov[dead_idx[0]])  # restarted from the snapshot

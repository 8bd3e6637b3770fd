"""Parity of the PyTorch port's fleet Monte-Carlo harness with the JAX package
(float64, CPU): the port's own copies of the survey mission setup
(``models/fleet_setup.py``) against ``examples/icra18_mission.py``, and
``run_fleet_mission`` on both paths against JAX ``path="bank"`` with every
noise sigma zero (the two packages draw different noise from the same
seed), plus a seeded noisy run.

Tolerances: the setup is closed-form (rtol 1e-12 / atol 1e-12, exact for
the numpy parts); the replay is a trajectory, rtol 1e-6 / atol 1e-9.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from slam_uwv_kalman_filters_tpu.models import monte_carlo as jmc
from slam_uwv_kalman_filters_tpu.parallel import bank as jbank
from slam_uwv_kalman_filters_tpu_torch.models import fleet_setup as tfs
from slam_uwv_kalman_filters_tpu_torch.models import monte_carlo as tmc
from slam_uwv_kalman_filters_tpu_torch.parallel import bank as tbank

from torch_parity import assert_tree_close, np_tree, pt

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

import icra18_mission  # noqa: E402

TRAJ = dict(rtol=1e-6, atol=1e-9)
SETUP = dict(rtol=1e-12, atol=1e-12)
ZERO_NOISE = dict(gyro_sigma=0.0, acc_sigma=0.0, dvl_sigma=0.0, pressure_sigma=0.0,
                  gps_lat_sigma=0.0, gps_lon_sigma=0.0)


@pytest.mark.parametrize("noise", [True, False])
def test_simulate_mission_equals_the_example(noise):
    args = (700, 0.01)
    ref = icra18_mission.simulate_mission(*args, np.random.default_rng(3), noise=noise)
    out = tfs.simulate_mission(*args, np.random.default_rng(3), noise=noise)
    assert ref.keys() == out.keys()
    for key in ref:
        np.testing.assert_array_equal(np.asarray(out[key]), np.asarray(ref[key]), err_msg=key)


def test_build_fleet_setup_and_monte_carlo_params_equal_the_example():
    jstate, jparams, jspec = icra18_mission.build_fleet_setup(minutes=0.05, rate=20.0, dtype_name="f64")
    tstate, tparams, tspec = tfs.build_fleet_setup(minutes=0.05, rate=20.0, dtype_name="f64", device="cpu")
    assert_tree_close(tstate, jstate, **SETUP, what="state")
    assert_tree_close(tparams, jparams, **SETUP, what="params")
    assert_tree_close(tspec, jspec, **SETUP, what="spec")
    jb = icra18_mission.monte_carlo_params(jparams, 5, jax.numpy.float64)
    tb = tfs.monte_carlo_params(tparams, 5, torch.float64)
    assert_tree_close(tb, jb, **SETUP, what="banked params")


@pytest.fixture(scope="module")
def fleet():
    """JAX-perturbed bank of 2 on a 3-second survey at 20 Hz (60 ticks, one
    gated fix), banked Monte-Carlo parameters, zero noise."""
    state, params, spec = icra18_mission.build_fleet_setup(minutes=0.05, rate=20.0, dtype_name="f64")
    bstate = jmc.perturb_initial_bank(jbank.replicate(state, 2), jax.random.PRNGKey(3))
    bparams = icra18_mission.monte_carlo_params(params, 2, jax.numpy.float64)
    spec = spec._replace(**ZERO_NOISE)
    ref = jmc.run_fleet_mission(bstate, bparams, spec, jax.random.PRNGKey(9), path="bank")
    return np_tree(bstate), np_tree(bparams), np_tree(spec), ref


@pytest.mark.parametrize("path", ["lanes", "bank"])
def test_run_fleet_mission_matches_jax_without_noise(fleet, path):
    bstate, bparams, spec, ref = fleet
    gen = torch.Generator().manual_seed(0)
    out = tmc.run_fleet_mission(pt(bstate), pt(bparams), pt(spec), gen, path=path)
    assert_tree_close(out, ref, **TRAJ, what=path)


def test_seeded_noisy_run_is_reproducible_and_finite():
    state, params, spec = tfs.build_fleet_setup(minutes=0.05, rate=20.0, dtype_name="f64", device="cpu")
    bparams = tfs.monte_carlo_params(params, 3, torch.float64)

    def run(seed):
        bs = tmc.perturb_initial_bank(tbank.replicate(state, 3), torch.Generator().manual_seed(seed),
                                      pos_sigma=0.05, vel_sigma=0.05, yaw_sigma=3e-3)
        return tmc.run_fleet_mission(bs, bparams, spec, torch.Generator().manual_seed(seed), path="lanes")

    a, b, c = run(1), run(1), run(2)
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    assert torch.isfinite(a.ate).all() and torch.isfinite(a.final_state.cov).all()
    assert not torch.equal(a.ate, c.ate)
    assert bool((a.gps_accept_frac == 1.0).all())
    assert bool((a.ate < 0.5).all())
    with pytest.raises(ValueError, match="path"):
        tmc.run_fleet_mission(tbank.replicate(state, 1), params, spec, torch.Generator(), path="scan")

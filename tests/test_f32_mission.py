"""f32 — the dtype that actually runs on the chip — asserted end-to-end.

VERDICT r2: the ATE acceptance tests ran f64 only, so nothing bounded
whole-mission drift at the deployment dtype. These tests close that loop on
CPU (same scenario family as ``test_examples.py``):

* the 1-minute ICRA'18 mission replay at f32 through the generic scan path
  must hold the same 10 cm north-star bound as the f64 test;
* a kernel-path mission: ``run_trajectory_bank(use_fused="interpret")`` runs
  the exact production Pallas kernels (fused predict + in-kernel measurement
  models) through the interpreter for a multi-second schedule and must agree
  with the generic f32 bank path at trajectory level — per-step parity
  (``test_pose_fused.py``) cannot bound accumulated divergence.

``bench.py`` carries the on-TPU half: its ``ate_m`` field replays the same
mission at f32 on the real chip every round.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_uwv_kalman_filters_tpu.models import pose_driver as drv
from slam_uwv_kalman_filters_tpu.models import pose_ukf as pukf
from slam_uwv_kalman_filters_tpu.ops import dynamics as dyn
from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod
from slam_uwv_kalman_filters_tpu.utils import metrics
from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config
from test_trajectory import simulate_truth

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

import icra18_mission

CFG = default_pose_ukf_config()


def test_icra18_mission_ate_bound_f32():
    """North-star acceptance at the deployment dtype: f32 whole-trajectory
    drift stays inside the 10 cm bound (measured 0.027 m — ~2.7x the f64
    figure, dominated by covariance roundoff, still 3.7x inside the bound)."""
    ate, dist = icra18_mission.main(["--cpu", "--minutes", "1.0", "--dtype", "f32"])
    assert dist > 30.0
    assert ate < 0.10, f"f32 ATE {ate:.3f} m exceeds the 10 cm acceptance bound"


@pytest.mark.slow
@pytest.mark.time_limit(400)
def test_kernel_path_mission_f32_interpret():
    """Trajectory-level run of the EXACT production kernels: a 4 s
    IMU+DVL+pressure mission through ``run_trajectory_bank`` with
    ``use_fused="interpret"`` (fused Pallas predict + streamed in-kernel
    measurement updates, executed by the Pallas interpreter) versus the
    generic vmap bank path at the same f32 dtype."""
    T = 400
    dt = 0.01
    truth = simulate_truth(T, dt)
    rng = np.random.default_rng(7)
    dtype = jnp.float32

    import oracle as orc

    gyro_n = truth["gyro"] + rng.normal(0, 3e-5, (T, 3))
    acc_n = truth["accel"] + rng.normal(0, 2e-3, (T, 3))
    dvl_valid = (np.arange(T) % 20) == 19
    dvl = np.zeros((T, 3))
    for k in np.where(dvl_valid)[0]:
        dvl[k] = orc.q_to_mat(truth["q"][k + 1]).T @ truth["vel"][k + 1] + rng.normal(0, 0.01, 3)
    press_valid = (np.arange(T) % 50) == 49
    rho = CFG.hydrostatics.water_density
    p_atm = CFG.hydrostatics.atmospheric_pressure
    press = p_atm - truth["pos"][1:, 2:3] * truth["g"] * rho + rng.normal(0, 50.0, (T, 1))

    inputs = drv.make_inputs(
        T,
        dt,
        gyro_n,
        acc=acc_n,
        acc_cov=np.eye(3) * (2e-3) ** 2 * 10,
        dvl=dvl,
        dvl_cov=np.eye(3) * 1e-4,
        dvl_valid=dvl_valid,
        pressure=press,
        pressure_cov=np.eye(1) * 50.0**2,
        pressure_valid=press_valid,
        dtype=dtype,
    )
    state, params = pukf.init_from_pose(
        imu_in_nwu_pos=jnp.asarray(truth["pos"][0], dtype),
        imu_in_nwu_pos_cov=jnp.eye(3, dtype=dtype) * 0.01,
        imu_in_nwu_rot=jnp.asarray(truth["q"][0], dtype),
        imu_in_nwu_rot_cov=jnp.eye(3, dtype=dtype) * 1e-4,
        config=CFG,
        model_parameters=dyn.default_uwv_parameters(dtype=dtype),
        imu_delta_t=dt,
        dtype=dtype,
    )
    bstate = bankmod.replicate(state, 1)
    binputs = jax.tree_util.tree_map(lambda a: a[:, None, ...], inputs)

    run_kernel = jax.jit(
        lambda s, p, i: drv.run_trajectory_bank(s, p, i, use_fused="interpret")
    )
    run_generic = jax.jit(
        lambda s, p, i: drv.run_trajectory_bank(s, p, i, use_fused=False)
    )
    _, outs_k = run_kernel(bstate, params, binputs)
    _, outs_g = run_generic(bstate, params, binputs)

    est_k = np.asarray(outs_k.position)[:, 0]
    est_g = np.asarray(outs_g.position)[:, 0]
    tru = truth["pos"][1:]

    ate_k = float(metrics.ate_rmse(jnp.asarray(est_k), jnp.asarray(tru, est_k.dtype)))
    assert np.all(np.isfinite(np.asarray(outs_k.cov_trace)))
    assert ate_k < 0.10, f"kernel-path f32 ATE {ate_k:.3f} m"

    # accumulated kernel-vs-generic divergence stays at f32-roundoff scale
    # over the whole mission, not just per step
    path_div = float(np.abs(est_k - est_g).max())
    assert path_div < 5e-3, f"kernel path diverged {path_div:.2e} m from generic f32"

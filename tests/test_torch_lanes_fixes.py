"""The lanes forms of the driver's surface fixes
(``slam_uwv_kalman_filters_tpu_torch/models/pose_driver.py``:
``gps_update_lanes``, ``delayed_xy_update_lanes``) against the JAX package's
bank forms (``update_geographic_position_bank``,
``update_delayed_position_bank``), float64 on the CPU at bank 4: one fix each
(GPS with a per-instance lever-arm correction and one instance outside the
χ²-95 gate), and a 1000-tick lanes trajectory (``run_trajectory_bank_lanes``)
with a GPS fix every 100 ticks against JAX's generic bank replay.

Tolerances: one fix rtol 1e-8 / atol 1e-10 and the trajectory rtol 1e-6 /
atol 1e-9, as tests/test_torch_pose_driver.py holds the lanes replay (K3's
plain version against the generic update).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from slam_uwv_kalman_filters_tpu.models import pose_driver as jdrv
from slam_uwv_kalman_filters_tpu.models import pose_ukf as jpukf
from slam_uwv_kalman_filters_tpu.ops import geodesy as jgeo
from slam_uwv_kalman_filters_tpu_torch.models import pose_driver as tdrv
from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf

from torch_parity import assert_tree_close, jx, mission_init, np_tree, pt, random_bank

STEP = dict(rtol=1e-8, atol=1e-10)
TRAJ = dict(rtol=1e-6, atol=1e-9)
NB = 4


def _bank(seed):
    state, params = mission_init()
    return random_bank(np.random.default_rng(seed), state, NB, spread=0.2), params


def _close_info(info, ref):
    np.testing.assert_array_equal(info.accepted.numpy(), np.asarray(ref.accepted))
    np.testing.assert_allclose(info.mahalanobis2.numpy(), np.asarray(ref.mahalanobis2), **STEP)
    np.testing.assert_allclose(info.innovation.numpy(), np.asarray(ref.innovation), **STEP)


def test_gps_update_lanes_matches_the_jax_bank_form():
    bstate, params = _bank(41)
    rng = np.random.default_rng(42)
    xy = bstate.mu.position[:, :2] + rng.normal(scale=0.3, size=(NB, 2))
    xy[0] += 40.0  # instance 0 fails the χ²-95 gate
    lat, lon = (np.array(a) for a in jgeo.nav_to_world(jx(params.projection), jnp.asarray(xy[:, 0]),
                                                         jnp.asarray(xy[:, 1])))
    cov, lever = np.eye(2) * 0.25, np.array([0.1, -0.2, 0.3])
    ref_state, ref_info = jpukf.update_geographic_position_bank(
        jx(bstate), jx(params), jnp.asarray(lat), jnp.asarray(lon), jnp.asarray(cov), jnp.asarray(lever),
        use_fused=False)
    tb = pt(bstate)
    ls, info = tdrv.gps_update_lanes(pf.to_lanes(tb), pt(params), torch.as_tensor(lat), torch.as_tensor(lon),
                                     torch.as_tensor(cov), torch.as_tensor(lever))
    assert_tree_close(pf.from_lanes(ls, tb), ref_state, **STEP, what="gps")
    _close_info(info, ref_info)
    assert not bool(info.accepted[0]) and bool(info.accepted[1:].all())


def test_delayed_xy_update_lanes_matches_the_jax_bank_form():
    bstate, params = _bank(43)
    rng = np.random.default_rng(44)
    delayed = bstate.mu.position[:, :2] + rng.normal(scale=0.2, size=(NB, 2))
    z = delayed + rng.normal(scale=0.1, size=(NB, 2))
    cov = np.eye(2) * 0.01
    ref_state, ref_info = jpukf.update_delayed_position_bank(jx(bstate), jx(params), jnp.asarray(z),
                                                             jnp.asarray(cov), jnp.asarray(delayed), use_fused=False)
    tb = pt(bstate)
    ls, info = tdrv.delayed_xy_update_lanes(pf.to_lanes(tb), torch.as_tensor(z), torch.as_tensor(cov),
                                            torch.as_tensor(delayed))
    assert_tree_close(pf.from_lanes(ls, tb), ref_state, **STEP, what="delayed xy")
    _close_info(info, ref_info)


def test_lanes_trajectory_with_a_gps_fix_every_100_ticks_matches_jax():
    T, dt = 1000, 0.01
    state, params = np_tree(mission_init())
    rng = np.random.default_rng(45)
    bstate = jax.tree.map(lambda a: np.broadcast_to(a, (NB, *np.shape(a))).copy(), state)
    bstate = bstate._replace(mu=bstate.mu._replace(position=rng.normal(scale=0.5, size=(NB, 3))))
    g = float(jgeo.wgs84_gravity(0.822, 0.0))
    every = lambda period: np.repeat((np.arange(T) % period == period - 1)[:, None], NB, 1).reshape(-1)
    fix_xy = rng.normal(scale=0.3, size=(T * NB, 2))
    lat, lon = jgeo.nav_to_world(jx(params.projection), jnp.asarray(fix_xy[:, 0]), jnp.asarray(fix_xy[:, 1]))
    kw = dict(
        acc=(np.array([0.0, 0.0, g]) + rng.normal(scale=2e-3, size=(T * NB, 3))), acc_cov=np.eye(3) * 4e-5,
        dvl=rng.normal(scale=1e-2, size=(T * NB, 3)), dvl_cov=np.eye(3) * 1e-3, dvl_valid=every(20),
        gps=np.stack([np.asarray(lat), np.asarray(lon)], -1), gps_cov=np.eye(2) * 0.25, gps_valid=every(100),
    )
    rr = np.tile([0.0, 0.0, 0.01], (T * NB, 1))
    jin = jdrv.make_inputs(T * NB, dt, rr, **kw, dtype=jnp.float64)
    tin = tdrv.make_inputs(T * NB, dt, torch.tensor(rr), **{k: torch.tensor(np.asarray(v)) for k, v in kw.items()},
                           device="cpu")
    shape = lambda x: x.reshape(T, NB, *x.shape[1:])
    drop = dict(pressure=None, pressure_cov=None, pressure_valid=None, xy=None, xy_cov=None, xy_valid=None,
                adcp=None, adcp_cov=None, adcp_cell_weighting=None, adcp_valid=None, efforts=None, efforts_cov=None,
                efforts_valid=None)
    jin = jax.tree.map(shape, jin)._replace(**drop)
    tin = tdrv.PoseInputs(*(None if x is None else shape(x) for x in tin))._replace(**drop)
    ref_s, ref_o = jdrv.run_trajectory_bank(jx(bstate), jx(params), jin, use_fused=False)
    out_s, out_o = tdrv.run_trajectory_bank_lanes(pt(bstate), pt(params), tin)
    assert torch.isfinite(out_s.cov).all()
    assert_tree_close(out_s, ref_s, **TRAJ, what="1000 ticks")
    np.testing.assert_array_equal(out_o.gps_accepted.numpy(), np.asarray(ref_o.gps_accepted))
    assert int(out_o.gps_accepted.sum()) > 0
    np.testing.assert_allclose(out_o.position.numpy(), np.asarray(ref_o.position), **TRAJ)

"""Parity of the PyTorch port's banked SPD solve (the plain version of kernel
K8, which a CPU tensor takes), ``ops.ukf.smooth_step`` and the PoseUKF RTS
smoother (``models/pose_smoother.py``) with the JAX package at float64 on
the CPU.

Tolerances: the solve at rtol 1e-9 / atol 1e-12 (equilibrated Cholesky and
two substitutions against the JAX CPU route's equilibrated ``cho_solve``,
the same factor in another order); ``smooth_step`` at the JAX test's rtol
1e-9 / 1e-8; the 100-tick smoothed trajectory at rtol 1e-6 / atol 1e-8,
the port's PoseUKF trajectory tolerance (a 53-DOF forward pass and a
backward pass of 99 solves, each rounding in another order). The
ill-conditioned float32 solve is held to float64 as the JAX test holds its
own, and to no more than twice the JAX float32 error.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_uwv_kalman_filters_tpu.models import pose_driver as jdrv
from slam_uwv_kalman_filters_tpu.models import pose_smoother as jsm
from slam_uwv_kalman_filters_tpu.models import pose_ukf as jpukf
from slam_uwv_kalman_filters_tpu.ops import dynamics as jdyn
from slam_uwv_kalman_filters_tpu.ops import kernels as jkernels
from slam_uwv_kalman_filters_tpu.ops import manifolds as jmf
from slam_uwv_kalman_filters_tpu.ops import ukf as jukf
from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config
from slam_uwv_kalman_filters_tpu_torch.models import pose_driver as tdrv
from slam_uwv_kalman_filters_tpu_torch.models import pose_smoother as tsm
from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
from slam_uwv_kalman_filters_tpu_torch.ops import kernels as tkernels
from slam_uwv_kalman_filters_tpu_torch.ops import manifolds as tmf
from slam_uwv_kalman_filters_tpu_torch.ops import ukf as tukf
from slam_uwv_kalman_filters_tpu_torch.parallel.bank import tree_map

from torch_parity import assert_tree_close, jx, np_tree, pt, random_spd

SOLVE = dict(rtol=1e-9, atol=1e-12)
TRAJ = dict(rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("n,k", [(53, 53), (53, 1), (12, 4), (6, 3)])
def test_solve_spd_matches_jax(n, k):
    """Random SPD systems whose variances span 1e-11 … 1e1 (the PoseUKF's
    range), n = 53 with k = 53 (the smoother's gain) and k = 1, a small
    n above the unrolled limit, and n = 6 (the unrolled substitution)."""
    rng = np.random.default_rng(400 + n + k)
    a = random_spd(rng, n, 5, 10.0 ** rng.uniform(-5.5, 0.5, n))
    b = rng.normal(size=(5, n, k))
    ref = np.asarray(jkernels.solve_spd_banked(jnp.asarray(a), jnp.asarray(b)))
    out = tkernels.solve_spd_banked(torch.tensor(a), torch.tensor(b))
    np.testing.assert_allclose(out.numpy(), ref, **SOLVE)
    np.testing.assert_allclose(tkernels.solve_spd_banked(torch.tensor(a[0]), torch.tensor(b[0])).numpy(), ref[0],
                               **SOLVE)
    if n > 8:  # the lanes form reads the valid half only
        a_t = torch.tensor(np.transpose(a, (2, 1, 0))).contiguous()
        n_ = torch.tril(torch.ones(n, n, dtype=torch.bool), -1)[..., None]
        a_t = torch.where(n_, float("nan"), a_t)
        x_t = tkernels.solve_spd_lanes_plain(a_t, torch.tensor(np.transpose(b, (1, 2, 0))).contiguous())
        np.testing.assert_allclose(x_t.permute(2, 0, 1).numpy(), ref, **SOLVE)


def test_solve_spd_float32_survives_condition():
    """The ill-conditioned float32 case of the JAX package's smoother test:
    equilibration keeps the solve finite and accurate."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=(2, 53, 53)).astype(np.float32)
    base = a @ a.transpose(0, 2, 1) + 53 * np.eye(53, dtype=np.float32)
    d = (10.0 ** rng.uniform(-5.5, 0.5, 53)).astype(np.float32)
    ill = base * (d[None, :, None] * d[None, None, :])
    rhs = rng.normal(size=(2, 53, 4)).astype(np.float32)
    ref = np.linalg.solve(ill.astype(np.float64), rhs.astype(np.float64))
    err = lambda x: np.max(np.abs(np.asarray(x, np.float64) - ref) / (np.abs(ref) + 1.0))
    out = tkernels.solve_spd_banked(torch.tensor(ill), torch.tensor(rhs))
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    jax_err = err(jkernels.solve_spd_banked(jnp.asarray(ill), jnp.asarray(rhs)))
    assert err(out) < 5e-2 and err(out) <= 2 * jax_err + 1e-6, (err(out), jax_err)


def _one(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


class Lin(NamedTuple):
    x: object


def test_smooth_step_matches_jax_and_linear_rts():
    """The linear-Gaussian case of the JAX package's smoother test, at a bank
    of 3: the port's smooth_step against JAX's and the classical RTS."""
    rng = np.random.default_rng(11)
    n, nb = 4, 3
    A = rng.normal(size=(n, n)) * 0.4 + np.eye(n)
    Q = np.diag(rng.uniform(0.1, 0.5, n))
    mu_f, mu_s1 = rng.normal(size=(nb, n)), rng.normal(size=(nb, n))
    a, b = rng.normal(size=(nb, n, n)), rng.normal(size=(nb, n, n))
    P_f, P_s1 = a @ np.swapaxes(a, 1, 2) + n * np.eye(n), b @ np.swapaxes(b, 1, 2) + n * np.eye(n)
    jman = jmf.make_manifold(jmf.Field("x", "vec", n))
    ref_mu, ref_P = jax.vmap(lambda m, p, ms, ps: jukf.smooth_step(
        jman, Lin(m), p, lambda s: Lin(jnp.asarray(A) @ s.x), jnp.asarray(Q), Lin(ms), ps))(
        jnp.asarray(mu_f), jnp.asarray(P_f), jnp.asarray(mu_s1), jnp.asarray(P_s1))
    tman = tmf.make_manifold(tmf.Field("x", "vec", n))
    t = torch.tensor
    mu_s, P_s = tukf.smooth_step(tman, Lin(t(mu_f)), t(P_f), lambda s: Lin(s.x @ t(A).T), t(Q).expand(nb, n, n),
                                 Lin(t(mu_s1)), t(P_s1))
    np.testing.assert_allclose(mu_s.x.numpy(), np.asarray(ref_mu.x), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(P_s.numpy(), np.asarray(ref_P), rtol=1e-8, atol=1e-8)
    P_pred = A @ P_f @ A.T + Q
    G = P_f @ A.T @ np.linalg.inv(P_pred)
    mu_ref = mu_f + (G @ (mu_s1 - mu_f @ A.T)[..., None])[..., 0]
    np.testing.assert_allclose(mu_s.x.numpy(), mu_ref, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(P_s.numpy(), P_f + G @ (P_s1 - P_pred) @ np.swapaxes(G, 1, 2), rtol=1e-8, atol=1e-8)


def _survey():
    """The JAX package's sparse-fix survey: a 100-tick straight run at 0.5
    m/s with a DVL biased by +2 cm/s and XY fixes only at ticks 1 and 99;
    two trajectories, the second started 0.3 m off with a wider prior."""
    state, params = jpukf.init_from_pose(
        imu_in_nwu_pos=jnp.zeros(3), imu_in_nwu_pos_cov=jnp.eye(3) * 1e-4,
        imu_in_nwu_rot=jnp.array([1.0, 0, 0, 0]), imu_in_nwu_rot_cov=jnp.eye(3) * 1e-6,
        config=default_pose_ukf_config(), model_parameters=jdyn.default_uwv_parameters(), imu_delta_t=0.1,
    )
    n, dt, v = 100, 0.1, 0.5
    true_xy = np.stack([v * np.arange(n) * dt, np.zeros(n)], axis=1)
    xy_valid = np.zeros(n, bool)
    xy_valid[[1, n - 1]] = True
    inputs = jdrv.make_inputs(n, dt, rotation_rate=np.zeros((n, 3)), dvl=np.tile([v + 0.02, 0.0, 0.0], (n, 1)),
                              dvl_cov=np.eye(3) * 1e-4, xy=true_xy, xy_cov=np.eye(2) * 1e-6, xy_valid=xy_valid)
    other = state._replace(mu=state.mu._replace(position=state.mu.position + jnp.array([0.3, -0.2, 0.0])),
                           cov=state.cov.at[:3, :3].multiply(4.0))
    return [state, other], params, inputs, true_xy


def _port_inputs(inputs, nb=None):
    """The schedule as the port's tensors; with ``nb`` a (T, nb, …) bank of
    it."""
    inp = pt(np_tree(inputs))
    if nb is None:
        return inp
    n = inputs.dt.shape[0]
    return tdrv.PoseInputs(*(None if x is None else x[:, None].expand(n, nb, *x.shape[1:]) for x in inp))


@pytest.fixture(scope="module")
def smoothed():
    """The port's bank of the two survey trajectories, and the JAX solo runs."""
    states, params, inputs, true_xy = _survey()
    run = jax.jit(jsm.run_trajectory_smoothed)
    refs = [np_tree(run(s, params, inputs)) for s in states]
    bank = jax.tree.map(lambda *a: np.stack(a), *[np_tree(s) for s in states])
    out = tsm.run_trajectory_smoothed(pt(bank), pt(np_tree(params)), _port_inputs(inputs, 2))
    return out, refs, true_xy


def test_run_trajectory_smoothed_matches_jax(smoothed):
    """The port's bank of two trajectories (``pose_step_bank`` forward, the
    backward pass through K1's and K8's plain versions) against two JAX
    solo runs, and the JAX test's assertions on the port's own output: the
    smoother pulls the interior drift back, never raises the covariance
    trace, and leaves the last tick as it was."""
    out, refs, true_xy = smoothed
    n = true_xy.shape[0]
    for i, ref in enumerate(refs):
        mine = type(out)(*(tree_map(lambda a: a[:, i], f) for f in out))
        assert_tree_close(mine, ref, **TRAJ, what=f"trajectory {i}")
        filt_err = np.abs(mine.filtered_mu.position[:, 0].numpy() - true_xy[:, 0])
        smth_err = np.abs(mine.smoothed_mu.position[:, 0].numpy() - true_xy[:, 0])
        mid = slice(n // 4, 3 * n // 4)
        assert smth_err[mid].mean() < 0.5 * filt_err[mid].mean()
        ftr = torch.diagonal(mine.filtered_cov, dim1=1, dim2=2).sum(-1)
        stre = torch.diagonal(mine.smoothed_cov, dim1=1, dim2=2).sum(-1)
        assert bool((stre <= ftr + 1e-9).all())
        assert torch.equal(mine.smoothed_mu.position[-1], mine.filtered_mu.position[-1])


def test_solo_trajectory_matches_the_bank_on_the_cpu_route(smoothed):
    """One trajectory through ``pose_step`` (the first 20 ticks) against the
    bank's second trajectory over the same ticks smoothed from tick 19, with
    no kernel launched on the CPU."""
    out, _, _ = smoothed
    states, params, inputs, _ = _survey()
    short = jax.tree.map(lambda a: a[:20], inputs)
    cuda_lib.reset_launch_counts()
    solo = tsm.run_trajectory_smoothed(pt(np_tree(states[1])), pt(np_tree(params)), _port_inputs(short))
    assert all(k.launches == 0 for k in cuda_lib.KERNELS.values())
    np.testing.assert_allclose(solo.filtered_cov.numpy(), out.filtered_cov[:20, 1].numpy(), rtol=1e-9, atol=1e-12)
    ref_mu, ref_cov = tsm.smooth_backward(tree_map(lambda a: a[:20], out.filtered_mu),
                                          out.filtered_cov[:20], pt(np_tree(params)), _port_inputs(short, 2))
    np.testing.assert_allclose(solo.smoothed_cov.numpy(), ref_cov[:, 1].numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(solo.smoothed_mu.position.numpy(), ref_mu.position[:, 1].numpy(), rtol=1e-9,
                               atol=1e-12)


def test_bank_with_a_dt_that_differs_across_trajectories_raises(smoothed):
    """A bank whose dt differs across its trajectories no longer raises (the
    name is the test's record from when it did): both passes run the
    one-trajectory forms under ``torch.func.vmap`` over the bank axis, each
    trajectory with its own dt, and match JAX's
    ``jax.vmap(run_trajectory_smoothed, in_axes=(0, None, 1))`` on three
    trajectories over 40 ticks (one dt 0.05 s at three ticks, one jittered
    by ±1% every tick); ``smooth_backward`` alone gives the same smoothed
    pass. The shared-dt bank above keeps its route."""
    out, _, _ = smoothed
    states, params, inputs, _ = _survey()
    n, nb = 40, 3
    xy_valid = np.zeros(n, bool)
    xy_valid[[1, n - 1]] = True
    absent = dict.fromkeys(("acc", "acc_cov", "acc_valid", "pressure", "pressure_cov", "pressure_valid", "adcp",
                            "adcp_cov", "adcp_cell_weighting", "adcp_valid", "efforts", "efforts_cov",
                            "efforts_valid"))  # the survey's all-invalid slots, left out on both sides
    short = jax.tree.map(lambda a: a[:n], inputs)._replace(xy_valid=jnp.asarray(xy_valid), **absent)
    rng = np.random.default_rng(460)
    dt = np.tile(np.asarray(short.dt)[:, None], (1, nb))
    dt[[5, 17, 30], 1] = 0.05
    dt[:, 2] *= 1.0 + rng.uniform(-0.01, 0.01, n)
    banked = jax.tree.map(lambda a: np.broadcast_to(np.asarray(a)[:, None], (n, nb, *a.shape[1:])).copy(), short)
    banked = banked._replace(dt=dt)
    third = states[0]._replace(mu=states[0].mu._replace(velocity=states[0].mu.velocity + jnp.array([0.1, 0.0, 0.0])))
    bank = jax.tree.map(lambda *a: np.stack(a), *[np_tree(s) for s in (*states, third)])
    ref = jax.jit(jax.vmap(jsm.run_trajectory_smoothed, in_axes=(0, None, 1)))(jx(bank), jx(params), jx(banked))
    mine = tsm.run_trajectory_smoothed(pt(bank), pt(np_tree(params)), pt(banked))
    for i in range(nb):
        assert_tree_close(type(mine)(*(tree_map(lambda a: a[:, i], f) for f in mine)), _one(np_tree(ref), i),
                          **TRAJ, what=f"trajectory {i}")
    ftr = torch.diagonal(mine.filtered_cov, dim1=-2, dim2=-1).sum(-1)
    stre = torch.diagonal(mine.smoothed_cov, dim1=-2, dim2=-1).sum(-1)
    assert bool((stre <= ftr + 1e-9).all())
    mu, cov = tsm.smooth_backward(mine.filtered_mu, mine.filtered_cov, pt(np_tree(params)), pt(banked))
    assert torch.equal(cov, mine.smoothed_cov) and torch.equal(mu.position, mine.smoothed_mu.position)

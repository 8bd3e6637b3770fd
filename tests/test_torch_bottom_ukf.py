"""Parity of the PyTorch port's BottomUKF — the S² manifold operations, the
generic UKF update with an S²-valued measurement, the generic filter (solo,
bank, a banked process-noise sweep, the class wrapper) and the lanes path
(the plain version of kernel K7, which a CPU tensor takes) — with the JAX
package at float64 on the CPU.

Tolerances: the generic path one step at rtol 1e-8 / atol 1e-10, as the
port's other filters. The lanes path is held to the JAX *generic* path at
rtol 1e-9 / atol 1e-11 per step: it runs a fixed 4 Karcher iterations where
the generic mean iterates to 1e-12, takes the distance means about the zero
sigma point and forms the S² basis as 2/|v|²·vᵢvⱼ, and the ±symmetric sigma
set makes the first Karcher correction nearly exact, so the two agree to
~1e-14 (measured). A 1000-step trajectory of the lanes path against the JAX
generic path is held to rtol 1e-6 / atol 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_uwv_kalman_filters_tpu.models import bottom_fused as jbf
from slam_uwv_kalman_filters_tpu.models import bottom_ukf as jb
from slam_uwv_kalman_filters_tpu.ops import manifolds as jmf
from slam_uwv_kalman_filters_tpu.ops import ukf as jukf
from slam_uwv_kalman_filters_tpu_torch.models import bottom_fused as tbf
from slam_uwv_kalman_filters_tpu_torch.models import bottom_ukf as tb
from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
from slam_uwv_kalman_filters_tpu_torch.ops import manifolds as tmf
from slam_uwv_kalman_filters_tpu_torch.ops import ukf as tukf

from slam_uwv_kalman_filters_tpu_torch.utils.convert import from_numpy

from torch_parity import assert_tree_close, jx, np_tree, pt, step_updates

STEP = dict(rtol=1e-8, atol=1e-10)
LANES = dict(rtol=1e-9, atol=1e-11)
TRAJ = dict(rtol=1e-6, atol=1e-9)
DT = 0.1
NB = 6


def _unit(v):
    v = np.asarray(v, dtype=np.float64)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


# S² points where the construction changes: the pole (the degenerate-basis
# guard), both sides of the equator (the basis changes sides at x₂ = 0), and
# a generic tilt
S2_POINTS = {
    "pole": _unit([0.0, 0.0, 1.0]),
    "south_pole": _unit([0.0, 0.0, -1.0]),
    "equator_above": _unit([0.6, 0.8, 1e-9]),
    "equator_below": _unit([0.6, -0.8, -1e-9]),
    "tilted": _unit([0.15, -0.1, 0.98]),
}


@pytest.mark.parametrize("where", list(S2_POINTS))
def test_s2_ops_match_jax(where):
    """Basis, ⊞, ⊟ (incl. the identity and the antipode) and the iterative
    mean at one point."""
    rng = np.random.default_rng(300)
    x = S2_POINTS[where]
    deltas = rng.normal(0.0, 0.4, (8, 2))
    tx = torch.tensor(x)
    np.testing.assert_allclose(tmf.s2_tangent_basis(tx).numpy(), np.asarray(jmf.s2_tangent_basis(jnp.asarray(x))),
                               **STEP)
    ys_ref = np.stack([np.asarray(jmf.s2_boxplus(jnp.asarray(x), jnp.asarray(d))) for d in deltas])
    ys = tmf.s2_boxplus(tx.expand(8, 3), torch.tensor(deltas))
    np.testing.assert_allclose(ys.numpy(), ys_ref, **STEP)
    back_ref = np.stack([np.asarray(jmf.s2_boxminus(jnp.asarray(y), jnp.asarray(x))) for y in ys_ref])
    np.testing.assert_allclose(tmf.s2_boxminus(ys, tx).numpy(), back_ref, **STEP)
    np.testing.assert_allclose(tmf.s2_boxminus(ys, tx).numpy(), deltas, rtol=1e-9, atol=1e-12)
    for y in (x, -x):  # y = x gives 0; the antipode gives π along the first basis column
        np.testing.assert_allclose(tmf.s2_boxminus(torch.tensor(y), tx).numpy(),
                                   np.asarray(jmf.s2_boxminus(jnp.asarray(y), jnp.asarray(x))), **STEP)
    pts = ys[:7]
    ref = jmf.S2_MANIFOLD.mean(jnp.asarray(pts.numpy()))
    np.testing.assert_allclose(tmf.S2_MANIFOLD.mean(pts).numpy(), np.asarray(ref), **STEP)


def test_s2_fields_in_a_product_manifold():
    rng = np.random.default_rng(301)
    x = jb.BottomState(distance=np.array([3.0]), normal=S2_POINTS["tilted"])
    d = rng.normal(0.0, 0.2, 3)
    ref = jb.BOTTOM_MANIFOLD.boxplus(jx(x), jnp.asarray(d))
    out = tb.BOTTOM_MANIFOLD.boxplus(pt(x), torch.tensor(d))
    assert_tree_close(out, ref, **STEP)
    np.testing.assert_allclose(tb.BOTTOM_MANIFOLD.boxminus(out, pt(x)).numpy(),
                               np.asarray(jb.BOTTOM_MANIFOLD.boxminus(ref, jx(x))), **STEP)


@pytest.fixture(scope="module")
def bank():
    """Filters with correlated covariances, velocities and normals at the
    pole, just above and below the equator's basis flip, and tilted."""
    rng = np.random.default_rng(302)
    normals = np.stack([S2_POINTS["pole"], _unit([0.3, 0.2, 1e-9]), _unit([0.3, -0.2, -1e-9]),
                        *_unit(rng.normal(size=(NB - 3, 3)) * [0.2, 0.2, 1.0] + [0.0, 0.0, 0.5])])
    g = rng.normal(size=(NB, 3, 3)) * 0.1
    state = jb.BottomUKFState(
        mu=jb.BottomState(distance=12.0 + rng.normal(size=(NB, 1)), normal=normals),
        cov=g @ np.swapaxes(g, 1, 2) + np.diag([0.5, 0.02, 0.02]),
        velocity=rng.normal(0.0, 0.5, (NB, 3)),
    )
    a = rng.normal(size=(3, 3)) * 0.3
    return state, jb.BottomUKFParams(process_noise=a @ a.T + np.eye(3))


def _one(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


BEAM = _unit([0.1, 0.05, -0.99])
ORIGIN = np.array([0.2, 0.0, -0.1])


def test_update_with_meas_manifold_matches_jax(bank):
    """``ukf.update`` with an S²-valued measurement (its mean, dZ and the
    innovation on the sphere), with a gate."""
    bs, _ = bank
    rng = np.random.default_rng(303)
    z = _unit(bs.mu.normal + rng.normal(0.0, 0.05, (NB, 3)))
    r = np.eye(2) * 0.01

    def ref_one(m, c, zz):
        return jukf.update(jb.BOTTOM_MANIFOLD, m, c, zz, lambda chi: chi.normal, jnp.asarray(r),
                           meas_manifold=jmf.S2_MANIFOLD, gate_threshold=5.991)

    ref_mu, ref_cov, ref_info = jax.vmap(ref_one)(jx(bs.mu), jnp.asarray(bs.cov), jnp.asarray(z))
    s = pt(bs)
    mu, cov, info = tukf.update(tb.BOTTOM_MANIFOLD, s.mu, s.cov, torch.tensor(z), lambda chi: chi.normal,
                                torch.tensor(r), meas_manifold=tmf.S2_MANIFOLD, gate_threshold=5.991)
    assert_tree_close(mu, ref_mu, **STEP)
    np.testing.assert_allclose(cov.numpy(), np.asarray(ref_cov), **STEP)
    assert_tree_close(info, ref_info, **STEP)


def test_solo_predict_and_updates_match_jax(bank):
    bs, params = bank
    s = _one(bs, 3)
    ref = jb.predict(jx(s), jx(params), DT)
    out = tb.predict(pt(s), pt(params), DT)
    assert_tree_close(out, ref, **STEP, what="predict")
    ref_r, ref_ri = jb.update_range(ref, jnp.array([11.7]), jnp.array([[0.04]]), jnp.asarray(BEAM), jnp.asarray(ORIGIN))
    out_r, out_ri = tb.update_range(out, np.array([11.7]), np.array([[0.04]]), BEAM, ORIGIN)
    assert_tree_close(out_r, ref_r, **STEP, what="range")
    assert_tree_close(out_ri, ref_ri, **STEP, what="range info")
    zn = _unit(np.asarray(ref.mu.normal) + [0.05, -0.02, 0.0])
    ref_n, ref_ni = jb.update_normal(ref_r, jnp.asarray(zn), jnp.eye(2) * 0.01)
    out_n, out_ni = tb.update_normal(out_r, torch.tensor(zn), torch.eye(2, dtype=torch.float64) * 0.01)
    assert_tree_close(out_n, ref_n, **STEP, what="normal")
    assert_tree_close(out_ni, ref_ni, **STEP, what="normal info")


def test_bank_paths_match_jax(bank):
    """The bank API (generic path on the CPU) with a shared process noise and
    a banked (B, 3, 3) sweep; per-instance beams."""
    bs, params = bank
    rng = np.random.default_rng(304)
    scale = 1.0 + 0.3 * rng.uniform(-1.0, 1.0, NB)
    for name, p in {"shared": params,
                    "banked": params._replace(process_noise=params.process_noise[None] * scale[:, None, None])}.items():
        ref = jb.predict_bank(jx(bs), jx(p), DT, use_fused=False)
        out = tb.predict_bank(pt(bs), pt(p), DT)
        assert_tree_close(out, ref, **STEP, what=f"predict_bank {name}")
    beams = _unit(rng.normal(size=(NB, 3)) * [0.2, 0.2, 0.1] + [0.0, 0.0, -1.0])
    z = 12.0 + rng.normal(0.0, 0.5, (NB, 1))
    ref_r, ref_ri = jb.update_range_bank(ref, jnp.asarray(z), jnp.array([[0.04]]), jnp.asarray(beams),
                                         jnp.asarray(ORIGIN), use_fused=False)
    out_r, out_ri = tb.update_range_bank(out, torch.tensor(z), np.array([[0.04]]), torch.tensor(beams),
                                         torch.tensor(ORIGIN))
    assert_tree_close(out_r, ref_r, **STEP, what="update_range_bank")
    assert_tree_close(out_ri, ref_ri, **STEP, what="update_range_bank info")
    zn = _unit(np.asarray(ref_r.mu.normal) + rng.normal(0.0, 0.05, (NB, 3)))
    ref_n, _ = jb.update_normal_bank(ref_r, jnp.asarray(zn), jnp.eye(2) * 0.01, use_fused=False)
    out_n, _ = tb.update_normal_bank(out_r, torch.tensor(zn), torch.eye(2, dtype=torch.float64) * 0.01)
    assert_tree_close(out_n, ref_n, **STEP, what="update_normal_bank")


def test_class_wrapper(bank):
    bs, _ = bank
    s = _one(bs, 4)
    cov = np.asarray(s.cov)
    ref = jb.BottomUKF(jx(s.mu), jnp.asarray(cov))
    f = tb.BottomUKF(pt(s.mu), torch.tensor(cov))
    for filt in (ref, f):
        filt.set_velocity(np.array([0.5, 0.0, -0.1]))
        filt.set_process_noise_covariance(np.eye(3) * 2.0)
        filt.prediction_step(DT)
    ref_info = ref.integrate_range_measurement(np.array([11.8]), np.array([[0.01]]), np.array([0, 0, -1.0]),
                                               np.zeros(3))
    info = f.integrate_range_measurement(np.array([11.8]), np.array([[0.01]]), np.array([0, 0, -1.0]), np.zeros(3))
    np.testing.assert_allclose(float(info.mahalanobis2), float(ref_info.mahalanobis2), **STEP)
    zn = _unit([0.1, 0.05, 1.0])
    ref.integrate_normal_measurement(zn, np.eye(2) * 1e-3)
    f.integrate_normal_measurement(zn, np.eye(2) * 1e-3)
    assert_tree_close(f.state, ref.state, **STEP)
    assert_tree_close(f.mu, ref.mu, **STEP)
    with pytest.raises(ValueError, match="NaN"):
        f.integrate_range_measurement(np.array([np.nan]), np.array([[0.01]]), np.array([0, 0, -1.0]), np.zeros(3))


# ---------------------------------------------------------------------------
# the lanes path (K7's plain version) against the JAX generic path
# ---------------------------------------------------------------------------


def _ref_update(s, model, z, r, thr=None, beam=BEAM, origin=ORIGIN):
    """One JAX generic update of a bank, optionally gated."""
    if model == "range":
        h = lambda chi: jnp.atleast_1d(
            jnp.where(jnp.dot(jnp.asarray(beam), chi.normal) == 0.0, 0.0,
                      jnp.dot(jnp.array([0.0, 0.0, -chi.distance[0]]) - jnp.asarray(origin), chi.normal)
                      / jnp.dot(jnp.asarray(beam), chi.normal)))
        one = lambda m, c, zz: jukf.update(jb.BOTTOM_MANIFOLD, m, c, zz, h, jnp.asarray(r), gate_threshold=thr)
    else:
        one = lambda m, c, zz: jukf.update(jb.BOTTOM_MANIFOLD, m, c, zz, lambda chi: chi.normal, jnp.asarray(r),
                                           meas_manifold=jmf.S2_MANIFOLD, gate_threshold=thr)
    mu, cov, info = jax.vmap(one)(s.mu, s.cov, jnp.asarray(z))
    return s._replace(mu=mu, cov=cov), info


def _assert_infos(got, want, opts=LANES):
    np.testing.assert_array_equal(got.accepted.numpy(), np.asarray(want.accepted))
    np.testing.assert_allclose(got.mahalanobis2.numpy(), np.asarray(want.mahalanobis2), **opts)
    np.testing.assert_allclose(got.innovation.numpy(), np.asarray(want.innovation), **opts)


def _updates(bs, rng):
    z = 12.0 + rng.normal(0.0, 0.5, (NB, 1))
    zn = _unit(bs.mu.normal + rng.normal(0.0, 0.05, (NB, 3)))
    return [("range", z, np.eye(1) * 0.04), ("normal", zn, np.eye(2) * 0.01)]


@pytest.mark.parametrize("case", ["predict", "range", "normal"])
def test_lanes_matches_jax_generic(bank, case):
    bs, params = bank
    rng = np.random.default_rng(305)
    ref = jb.predict_bank(jx(bs), jx(params), DT, use_fused=False)
    ls = tbf.predict_lanes(tbf.to_lanes(pt(bs)), pt(params), DT)
    if case != "predict":
        model, z, r = dict((u[0], u) for u in _updates(bs, rng))[case]
        ref, ref_info = _ref_update(ref, model, z, r)
        ls, info = tbf.update_model_lanes(model, ls, torch.tensor(z), torch.tensor(r),
                                          *((torch.tensor(BEAM), torch.tensor(ORIGIN)) if model == "range" else ()))
        _assert_infos(info, ref_info)
    assert_tree_close(tbf.from_lanes(ls, pt(bs)), ref, **LANES)


def test_lanes_chain_matches_sequential_updates(bank):
    """One step_lanes call (predict + range + normal, the JAX StepUpdate list
    carried over) against the JAX generic predict and updates one at a
    time, and against the port's split predict / update forms."""
    bs, params = bank
    ups = _updates(bs, np.random.default_rng(306))
    ref = jb.predict_bank(jx(bs), jx(params), DT, use_fused=False)
    ref_infos = []
    for model, z, r in ups:
        ref, info = _ref_update(ref, model, z, r)
        ref_infos.append(info)
    jax_updates = [jbf.StepUpdate("range", jnp.asarray(ups[0][1]), jnp.asarray(ups[0][2]), jnp.asarray(BEAM),
                                  jnp.asarray(ORIGIN)),
                   jbf.StepUpdate("normal", jnp.asarray(ups[1][1]), jnp.asarray(ups[1][2]))]
    ls, infos = tbf.step_lanes(tbf.to_lanes(pt(bs)), pt(params), DT, step_updates(jax_updates, tbf.StepUpdate))
    assert_tree_close(tbf.from_lanes(ls, pt(bs)), ref, **LANES)
    for got, want in zip(infos, ref_infos):
        _assert_infos(got, want)
    split = tbf.predict_lanes(tbf.to_lanes(pt(bs)), pt(params), DT)
    split, _ = tbf.update_model_lanes("range", split, torch.tensor(ups[0][1]), torch.tensor(ups[0][2]),
                                      torch.tensor(BEAM), torch.tensor(ORIGIN))
    split, _ = tbf.update_model_lanes("normal", split, torch.tensor(ups[1][1]), torch.tensor(ups[1][2]))
    assert torch.equal(split.cov_t, ls.cov_t) and torch.equal(split.mu_t, ls.mu_t)


def test_lanes_gate_rejects_and_keeps_the_prior(bank):
    """A χ² gate: instance 4's range is a wild outlier, instance 5's normal
    is far off; both keep their priors bit for bit."""
    bs, params = bank
    ups = _updates(bs, np.random.default_rng(307))
    (_, z, r), (_, zn, rn) = ups
    z[4] += 500.0
    zn[5] = _unit(zn[5] + [2.0, 0.0, 0.0])
    ls = tbf.to_lanes(pt(bs))
    ref = jx(bs)
    for model, zz, rr, thr in (("range", z, r, 3.841), ("normal", zn, rn, 5.991)):
        ref_out, ref_info = _ref_update(ref, model, zz, rr, thr)
        out, info = tbf.update_model_lanes(model, ls, torch.tensor(zz), torch.tensor(rr),
                                           *((torch.tensor(BEAM), torch.tensor(ORIGIN)) if model == "range" else (None, None)),
                                           gate_threshold=thr)
        _assert_infos(info, ref_info)
        assert_tree_close(tbf.from_lanes(out, pt(bs)), ref_out, **LANES)
        rejected = 4 if model == "range" else 5
        assert not bool(info.accepted[rejected]) and int(info.accepted.sum()) == NB - 1
        assert torch.equal(out.cov_t[..., rejected], ls.cov_t[..., rejected])
        assert torch.equal(out.mu_t[:, rejected], ls.mu_t[:, rejected])


def test_pad_lanes_stay_finite_and_leave_the_bank_alone(bank):
    """Three pad lanes (identity covariance, copies of instance 0, neutral
    measurements) change nothing in the true bank and stay finite."""
    bs, params = bank
    ups = [tbf.StepUpdate(m, torch.tensor(z), torch.tensor(r), *((torch.tensor(BEAM), torch.tensor(ORIGIN))
                                                               if m == "range" else ()))
           for m, z, r in _updates(bs, np.random.default_rng(308))]
    plain, _ = tbf.step_lanes(tbf.to_lanes(pt(bs)), pt(params), DT, ups)
    padded, infos = tbf.step_lanes(tbf.to_lanes(pt(bs), lanes=NB + 3), pt(params), DT, ups)
    assert padded.cov_t.shape[-1] == NB + 3 and all(i.mahalanobis2.shape == (NB,) for i in infos)
    assert torch.equal(padded.cov_t[..., :NB], plain.cov_t) and torch.equal(padded.mu_t[:, :NB], plain.mu_t)
    assert bool(torch.isfinite(padded.cov_t).all()) and bool(torch.isfinite(padded.mu_t).all())
    moved = tbf.set_velocity_lanes(padded, torch.ones(NB, 3, dtype=torch.float64))
    assert torch.equal(moved.vel_t, torch.ones(3, NB + 3, dtype=torch.float64))


def test_lanes_trajectory_matches_jax_generic(bank):
    """1000 steps at bank 4 (predict, a range every step, a normal every 5th,
    new velocities every 10th) of the lanes path against the JAX generic
    path."""
    bs, params = bank
    bs = jax.tree.map(lambda a: a[:4], bs)
    nb = 4
    rng = np.random.default_rng(309)
    n_steps = 1000
    vel = rng.normal(0.0, 0.3, (n_steps // 10, nb, 3))
    z = 12.0 + rng.normal(0.0, 0.3, (n_steps, nb, 1))
    zn = _unit(np.asarray(bs.mu.normal)[None] + rng.normal(0.0, 0.03, (n_steps, nb, 3)))
    r, rn = np.eye(1) * 0.04, np.eye(2) * 0.01
    p = jx(params)

    @jax.jit
    def ref_step(s, v, zk, znk, with_normal):
        s = s._replace(velocity=v)
        s = jb.predict_bank(s, p, DT, use_fused=False)
        s, _ = _ref_update(s, "range", zk, r)
        sn, _ = _ref_update(s, "normal", znk, rn)
        return jax.tree.map(lambda a, b: jnp.where(with_normal, a, b), sn, s)

    ref = jx(bs)
    ls = tbf.to_lanes(pt(bs))
    tp = pt(params)
    for k in range(n_steps):
        if k % 10 == 0:
            ls = tbf.set_velocity_lanes(ls, torch.tensor(vel[k // 10]))
        ups = [tbf.StepUpdate("range", torch.tensor(z[k]), torch.tensor(r), torch.tensor(BEAM), torch.tensor(ORIGIN))]
        if k % 5 == 4:
            ups.append(tbf.StepUpdate("normal", torch.tensor(zn[k]), torch.tensor(rn)))
        ls, _ = tbf.step_lanes(ls, tp, DT, ups)
        ref = ref_step(ref, jnp.asarray(vel[k // 10]), jnp.asarray(z[k]), jnp.asarray(zn[k]), k % 5 == 4)
    out = tbf.from_lanes(ls, pt(np_tree(ref)))
    assert bool(torch.isfinite(out.cov).all())
    assert_tree_close(out, ref, **TRAJ, what="trajectory")


def test_cpu_tensors_take_the_plain_route(bank):
    bs, params = bank
    cuda_lib.reset_launch_counts()
    tb.predict_bank(pt(bs), pt(params), DT)
    tbf.predict_fused_banked(pt(bs), pt(params), DT)
    tbf.update_model_fused_banked("normal", pt(bs), torch.tensor(bs.mu.normal), torch.eye(2, dtype=torch.float64))
    assert all(k.launches == 0 for k in cuda_lib.KERNELS.values())
    too_many = [tbf.StepUpdate("normal", torch.tensor(bs.mu.normal), torch.eye(2))] * (tbf.MAX_STEP_UPDATES + 1)
    with pytest.raises(ValueError, match="MAX_STEP_UPDATES"):
        tbf.step_lanes(tbf.to_lanes(pt(bs)), pt(params), DT, too_many)
    with pytest.raises(ValueError, match="direction and origin"):
        tbf.update_model_lanes("range", tbf.to_lanes(pt(bs)), torch.zeros(NB, 1), torch.eye(1))
    banked = params._replace(process_noise=np.stack([params.process_noise] * NB))
    with pytest.raises(ValueError, match="generic path"):
        tbf.predict_lanes(tbf.to_lanes(pt(bs)), pt(banked), DT)


def test_lanes_step_matches_jax_kernel_float32(bank):
    """The plain K7 at float32 against the JAX kernel (Pallas interpret mode)
    at bank 128, predict + range + normal: the lanes layout, the per-lane
    speed²·dt² noise and the in-kernel S² algebra. Both round float32; they
    differ in the atan2 (a Cephes polynomial on the TPU), the distance means
    (a plain sum on the TPU) and the order of the sums, so the bound is a
    few float32 ulps of the entries: rtol 2e-5 / atol 2e-6; the infos pass
    through the two atan2s, so NIS and innovation are held to rtol 1e-4 /
    atol 1e-5. The normals
    near the equator sit at x₂ = ±1e-3 here: at ±1e-9 float32 rounding of
    the Karcher mean decides the side of the basis, and the two versions may
    then express the same covariance in tangent bases of opposite sides."""
    bs, params = bank
    normals = bs.mu.normal.copy()
    normals[1], normals[2] = _unit([0.3, 0.2, 1e-3]), _unit([0.3, -0.2, -1e-3])
    bs = bs._replace(mu=bs.mu._replace(normal=normals))
    big =jax.tree.map(lambda a: np.concatenate([a] * 22)[:128].astype(np.float32), bs)
    p32 = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    rng = np.random.default_rng(310)
    z = (12.0 + rng.normal(0.0, 0.5, (128, 1))).astype(np.float32)
    zn = _unit(big.mu.normal + rng.normal(0.0, 0.05, (128, 3))).astype(np.float32)
    r, rn = np.eye(1, dtype=np.float32) * 0.04, np.eye(2, dtype=np.float32) * 0.01
    beam, origin = BEAM.astype(np.float32), ORIGIN.astype(np.float32)
    ref_ls, ref_infos = jbf.step_lanes(
        jbf.to_lanes(jx(big)), jx(p32), DT,
        [jbf.StepUpdate("range", jnp.asarray(z), r, jnp.asarray(beam), jnp.asarray(origin)),
         jbf.StepUpdate("normal", jnp.asarray(zn), rn)], interpret=True)
    t32 = lambda a: torch.tensor(a)
    ls, infos = tbf.step_lanes(
        tbf.to_lanes(from_numpy(big, device="cpu", dtype=torch.float32)),
        from_numpy(p32, device="cpu", dtype=torch.float32), DT,
        [tbf.StepUpdate("range", t32(z), t32(r), t32(beam), t32(origin)), tbf.StepUpdate("normal", t32(zn), t32(rn))])
    tol = dict(rtol=2e-5, atol=2e-6)
    for name in ("cov_t", "mu_t"):
        np.testing.assert_allclose(getattr(ls, name).numpy(), np.asarray(getattr(ref_ls, name)), **tol, err_msg=name)
    for got, want in zip(infos, ref_infos):
        np.testing.assert_allclose(got.mahalanobis2.numpy(), np.asarray(want.mahalanobis2), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got.innovation.numpy(), np.asarray(want.innovation), rtol=1e-4, atol=1e-5)

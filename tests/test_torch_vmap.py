"""``torch.func.vmap`` over the PyTorch port's per-filter functions, held
against ``jax.vmap`` of the JAX package's (float64, CPU).

The JAX package is built on ``vmap``: a function written for one filter runs
a bank under ``jax.vmap``, and ``ops/kernels.py``'s ``custom_vmap`` rules
turn the per-instance Cholesky, sigma deltas and SPD solve into one banked
launch. The port's counterparts are the vmap rules of the K1, K8 and K12
ops (``slam_uwv_kalman_filters_tpu_torch/ops/kernels.py``) and
``parallel/bank.vmap_filter``. On the CPU a rule folds the vmapped axes
into one call of the kernel's plain version, so these tests run the rules
themselves; ``tests/test_torch_cuda_kernels.py`` holds the card's launches.

Tolerances: a vmapped call of K1, K8 or K12 gives the bits of one banked
call on the stacked operands (``torch.equal``), and the JAX vmap of the
same function within the solve's rtol 1e-9 / atol 1e-12 (another
factorization order). ``vmap(pose_ukf.predict)`` gives ``predict_bank``'s
bits. A vmapped filter step is held to ``jax.vmap`` of the JAX step at the
port's one-step tolerance rtol 1e-8 / atol 1e-10, and to the port's own
bank form at rtol 1e-12 / atol 1e-14 (the same sums; only the batching
differs). The 1000-tick vmapped ``pose_step`` replay is held to a JAX
``lax.scan`` of ``jax.vmap(pose_step)`` at the trajectory tolerance rtol
1e-6 / atol 1e-9.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_uwv_kalman_filters_tpu.models import bottom_ukf as jb
from slam_uwv_kalman_filters_tpu.models import indirect_pose_ukf as ji
from slam_uwv_kalman_filters_tpu.models import pose_driver as jdrv
from slam_uwv_kalman_filters_tpu.models import pose_ukf as jpukf
from slam_uwv_kalman_filters_tpu.models import velocity_ukf as jv
from slam_uwv_kalman_filters_tpu.ops import dynamics as jdyn
from slam_uwv_kalman_filters_tpu.ops import geodesy as jgeo
from slam_uwv_kalman_filters_tpu.ops import kernels as jkernels
from slam_uwv_kalman_filters_tpu.ops import ukf as jukf
from slam_uwv_kalman_filters_tpu.parallel import bank as jbank
from slam_uwv_kalman_filters_tpu.utils.config import CameraConfiguration as JCam
from slam_uwv_kalman_filters_tpu_torch.models import bottom_ukf as tb
from slam_uwv_kalman_filters_tpu_torch.models import indirect_fused as tif
from slam_uwv_kalman_filters_tpu_torch.models import indirect_pose_ukf as ti
from slam_uwv_kalman_filters_tpu_torch.models import pose_driver as tdrv
from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as tpf
from slam_uwv_kalman_filters_tpu_torch.models import pose_ukf as tpukf
from slam_uwv_kalman_filters_tpu_torch.models import velocity_ukf as tv
from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
from slam_uwv_kalman_filters_tpu_torch.ops import kernels as tkernels
from slam_uwv_kalman_filters_tpu_torch.parallel import bank as tbank
from slam_uwv_kalman_filters_tpu_torch.utils.config import CameraConfiguration as TCam

from torch_parity import _quat_exp, _quat_mul, assert_tree_close, jx, mission_init, np_tree, pt, random_bank, \
    random_spd

STEP = dict(rtol=1e-8, atol=1e-10)
SOLVE = dict(rtol=1e-9, atol=1e-12)
SAME = dict(rtol=1e-12, atol=1e-14)
TRAJ = dict(rtol=1e-6, atol=1e-9)
DT = 0.01
NB = 3
F64 = torch.float64


def _close(port, ref, what="", **tol):
    """``assert_tree_close`` through plain tuples of NamedTuples too."""
    if type(ref) is tuple:
        assert type(port) is tuple and len(port) == len(ref), what
        for i, (p, r) in enumerate(zip(port, ref)):
            _close(p, r, f"{what}[{i}]", **tol)
    else:
        assert_tree_close(port, ref, what=what, **tol)


# ---------------------------------------------------------------------------
# the vmap rules of K1, K12 and K8
# ---------------------------------------------------------------------------

_FAST = {"sigma_deltas": (tkernels.sigma_deltas_fast, tkernels.sigma_deltas_banked, jkernels.sigma_deltas_fast),
         "cholesky": (tkernels.cholesky_fast, tkernels.cholesky_banked, jkernels.cholesky_fast)}


@pytest.mark.parametrize("layout", ["dim0", "dim1", "nested"])
@pytest.mark.parametrize("kernel", list(_FAST))
def test_factor_rule_gives_the_banked_bits(kernel, layout):
    """A vmapped call on one 53×53 matrix (or a bank of two) is one banked
    call on the stacked operands: its bits, and JAX's vmap of the same
    function. ``dim1`` maps over the second axis of a (2, V, 53, 53)
    stack; ``nested`` is a vmap of a vmap, folded level by level."""
    fast, banked, jfast = _FAST[kernel]
    rng = np.random.default_rng(1700 + len(layout))
    a = random_spd(rng, 53, 6, 10.0 ** rng.uniform(-5.5, 0.5, 53)).reshape(3, 2, 53, 53)
    t = torch.tensor(a)
    ref = banked(t.reshape(-1, 53, 53))
    if layout == "dim0":
        out = torch.func.vmap(fast)(t)  # each instance a bank of two
        jref = jax.vmap(jfast)(jnp.asarray(a.reshape(6, 53, 53))).reshape(*out.shape)
    elif layout == "dim1":
        out = torch.func.vmap(fast, in_dims=1)(t.transpose(0, 1))  # the (V, 2, …) order of t
        jref = jax.vmap(jfast)(jnp.asarray(a.reshape(6, 53, 53))).reshape(*out.shape)
    else:
        out = torch.func.vmap(torch.func.vmap(fast))(t)  # one matrix an instance
        jref = jax.vmap(jax.vmap(jfast))(jnp.asarray(a))
    assert torch.equal(out.reshape(ref.shape), ref)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), **SOLVE)


@pytest.mark.parametrize("dims", [(0, 0), (0, None), (None, 0), (1, 2), "nested"])
def test_solve_spd_rule_gives_the_banked_bits(dims):
    """K8's rule with both operands batched, one unbatched (expanded, as
    JAX's rule broadcasts it), a batch dim that is not the first, and a
    nested vmap: the bits of one banked solve on the stacked, expanded
    operands, and JAX's vmap of ``solve_spd_fast`` with the same axes."""
    rng = np.random.default_rng(1710)
    n, k, v = 53, 53, 4
    spd = random_spd(rng, n, v, 10.0 ** rng.uniform(-5.5, 0.5, n))
    rhs = rng.normal(size=(v, n, k))
    if dims == "nested":
        a4, b4 = spd.reshape(2, 2, n, n), rhs.reshape(2, 2, n, k)
        out = torch.func.vmap(torch.func.vmap(tkernels.solve_spd_fast))(torch.tensor(a4), torch.tensor(b4))
        jref = jax.vmap(jax.vmap(jkernels.solve_spd_fast))(jnp.asarray(a4), jnp.asarray(b4))
        ref = tkernels.solve_spd_banked(torch.tensor(spd), torch.tensor(rhs)).reshape(out.shape)
    else:
        da, db = dims
        a = spd[0] if da is None else np.moveaxis(spd, 0, da) if da < 2 else spd
        b = rhs[0] if db is None else np.moveaxis(rhs, 0, db)
        out = torch.func.vmap(tkernels.solve_spd_fast, in_dims=dims)(torch.tensor(a), torch.tensor(b))
        jref = jax.vmap(jkernels.solve_spd_fast, in_axes=dims)(jnp.asarray(a), jnp.asarray(b))
        sa = np.broadcast_to(spd[:1], spd.shape) if da is None else spd
        sb = np.broadcast_to(rhs[:1], rhs.shape) if db is None else rhs
        ref = tkernels.solve_spd_banked(torch.tensor(sa), torch.tensor(sb))
    assert torch.equal(out, ref)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), **SOLVE)


def test_lanes_rule_folds_into_the_lane_axis():
    """The lanes op (K1 in the bank-last layout) under vmap: the vmapped
    axis folds next to the lane axis, and the bits are those of one call on
    the (n, n, V·N) stack."""
    rng = np.random.default_rng(1720)
    a = random_spd(rng, 12, 8, 10.0 ** rng.uniform(-3, 0.5, 12))
    a_t = torch.tensor(np.transpose(a, (2, 1, 0))).reshape(12, 12, 2, 4).movedim(2, 0)  # (V, n, n, N)
    out = torch.func.vmap(tkernels.sigma_deltas_lanes)(a_t)
    ref = tkernels.sigma_deltas_lanes(a_t.movedim(0, 2).reshape(12, 12, 8))
    assert torch.equal(out.movedim(0, 2).reshape(ref.shape), ref)


def test_an_op_without_a_rule_raises_under_vmap():
    """K9's and K2's ops have no vmap rule: under vmap their entry points
    raise ``NotImplementedError`` naming the op, before any wrapper could
    read a batched tensor's pointer and without looping over the instances
    through the plain version."""
    z = torch.zeros(2, 6, 6, 4, dtype=F64)
    with pytest.raises(NotImplementedError, match="slam_uwv::indirect_predict"):
        torch.func.vmap(lambda c: tif._indirect_predict_lanes(c, c[0], c[0, 0]))(z)
    with pytest.raises(NotImplementedError, match="slam_uwv::pose_predict"):
        torch.func.vmap(lambda c: tpf._pose_predict_lanes(c, c[0], c[0], c, c, c, c[0, 0]))(z)
    assert not cuda_lib.is_vmapped(z)
    assert bool(torch.func.vmap(lambda c: torch.tensor(cuda_lib.is_vmapped(c)))(z).all())


# ---------------------------------------------------------------------------
# parallel/bank.vmap_filter, as tests/test_parallel.py uses JAX's
# ---------------------------------------------------------------------------


def _pose_filter():
    state, params = mission_init()
    return state, params


def test_masked_vmap_filter_per_instance_validity():
    """``masked(vmap_filter(update_velocity))``: invalid instances keep
    their state bit for bit, valid ones move, as JAX's."""
    state, params = _pose_filter()
    n = 4
    zs = np.tile([1.0, 0.0, 0.0], (n, 1))
    rs = np.tile(np.eye(3) * 1e-4, (n, 1, 1))
    valid = np.array([True, False, True, False])
    ref_s, ref_i = jax.jit(jbank.masked(jbank.vmap_filter(jpukf.update_velocity)))(
        jbank.replicate(jx(state), n), jnp.asarray(valid), jx(params), jnp.asarray(zs), jnp.asarray(rs))
    bstate = tbank.replicate(pt(state), n)
    out_s, out_i = tbank.masked(tbank.vmap_filter(tpukf.update_velocity))(
        bstate, torch.tensor(valid), pt(params), torch.tensor(zs), torch.tensor(rs))
    _close((out_s, out_i), (ref_s, ref_i), **STEP)
    moved = torch.linalg.vector_norm(out_s.mu.velocity, dim=1)
    assert moved[0] > 0.5 and moved[2] > 0.5
    assert float(moved[1]) == 0.0 and torch.equal(out_s.cov[1], bstate.cov[1])


def test_param_sweep_vmap_filter():
    """A per-instance parameter sweep (``params_axis=0``): three
    water-current time constants decay the current at three rates, as in
    JAX."""
    state, params = _pose_filter()
    n = 3
    taus = np.array([10.0, 100.0, 1000.0])
    wv = np.tile([0.2, 0.0], (n, 1))
    jp = jbank.replicate(jx(params), n)._replace(water_velocity_tau=jnp.asarray(taus))
    js = jbank.replicate(jx(state), n)
    js = js._replace(mu=js.mu._replace(water_velocity=jnp.asarray(wv)))
    ref = jax.jit(lambda s, p: jbank.vmap_filter(jpukf.predict, params_axis=0, data_axes=None)(s, p, 0.1))(js, jp)
    tp = tbank.replicate(pt(params), n)._replace(water_velocity_tau=torch.tensor(taus))
    ts = tbank.replicate(pt(state), n)
    ts = ts._replace(mu=ts.mu._replace(water_velocity=torch.tensor(wv)))
    out = tbank.vmap_filter(tpukf.predict, params_axis=0, data_axes=None)(ts, tp, 0.1)
    assert_tree_close(out, ref, **STEP)
    decays = out.mu.water_velocity[:, 0]
    assert decays[0] < decays[1] < decays[2] < 0.2


def test_vmapped_velocity_ukf_efforts_then_predict():
    """The VelocityUKF step of ``tests/test_parallel.py``'s sharded test:
    vmap of ``integrate_body_efforts`` then of ``predict``, against JAX, and
    against the port's bank form (the generic path on the CPU)."""
    n = 32
    mu = jv.VelocityState(velocity=jnp.zeros(3), z_position=jnp.zeros(1))
    state, params = jv.init(mu, jnp.eye(4) * 0.1, jdyn.default_uwv_parameters())
    taus = np.random.default_rng(1).normal(size=(n, 6)) * 20.0
    bs = jbank.replicate(state, n)
    ref = jax.jit(jax.vmap(lambda s, t: jv.predict(jv.integrate_body_efforts(s, t), params, 0.1)))(
        bs, jnp.asarray(taus))
    tp, tbs = pt(np_tree(params)), pt(np_tree(bs))
    out = tbank.vmap_filter(tv.integrate_body_efforts, state_axis=0, params_axis=0)(tbs, torch.tensor(taus))
    out = tbank.vmap_filter(tv.predict, data_axes=None)(out, tp, 0.1)
    assert_tree_close(out, ref, **STEP)
    bank_form = tv.predict_bank(tbs._replace(body_efforts=torch.tensor(taus)), tp, 0.1)
    assert_tree_close(out, np_tree(bank_form), **SAME)
    assert torch.allclose(out.mu.velocity.mean(0), torch.tensor(np.asarray(ref.mu.velocity.mean(0))), rtol=0,
                          atol=1e-12)


# ---------------------------------------------------------------------------
# the PoseUKF's solo functions under vmap
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pose_bank():
    state, params = mission_init()
    return random_bank(np.random.default_rng(1740), state, NB, spread=0.5), params


def test_vmapped_predict_is_the_bank_form_bit_for_bit(pose_bank):
    bs, params = pose_bank
    out = tbank.vmap_filter(tpukf.predict, data_axes=None)(pt(bs), pt(params), DT)
    ref = tpukf.predict_bank(pt(bs), pt(params), DT)
    for a, b in zip(tbank.tree_leaves(out), tbank.tree_leaves(ref)):
        assert torch.equal(a, b)


def _rotate(q, v):
    w, u = q[..., :1], q[..., 1:]
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


CAM_P, CAM_Q = np.array([0.1, -0.05, 0.02]), np.array([0.5, -0.5, 0.5, -0.5])
CORNERS = np.array([[0.15, 0.15, 0.0], [-0.15, 0.15, 0.0], [-0.15, -0.15, 0.0], [0.15, -0.15, 0.0]])
MARKER_P, MARKER_Q = np.array([6.0, 0.0, 0.0]), np.array([0.5, -0.5, 0.5, -0.5])


def _pixels(rng, pos, q):
    """(B, 4, 2) pixels of the marker's corners seen from the body poses,
    plus a pixel of noise."""
    cam = JCam()
    f_nav = _rotate(MARKER_Q, CORNERS) + MARKER_P
    cam_q = _quat_mul(q, np.broadcast_to(CAM_Q, q.shape))
    cam_p = pos + _rotate(q, np.broadcast_to(CAM_P, pos.shape))
    f = _rotate((cam_q * [1.0, -1.0, -1.0, -1.0])[:, None], f_nav - cam_p[:, None])
    px = np.stack([cam.fx * f[..., 0] / f[..., 2] + cam.cx, cam.fy * f[..., 1] / f[..., 2] + cam.cy], -1)
    return px + rng.normal(0.0, 1.0, px.shape)


def _pose_cases(bs, params):
    """name → (JAX solo function, port solo function, per-argument vmap
    dims after the state and params, numpy arguments)."""
    rng = np.random.default_rng(1741)
    mu = bs.mu
    g = float(jgeo.wgs84_gravity(0.822, 0.0))
    acc = np.tile([0.0, 0.0, g], (NB, 1)) + rng.normal(0.0, 0.01, (NB, 3))
    xy = np.asarray(mu.position[:, :2]) + rng.normal(0.0, 0.5, (NB, 2))
    xy[0] += 30.0  # instance 0 fails the χ²-95 gate
    lat, lon = (np.asarray(a) for a in jgeo.nav_to_world(jx(params.projection), jnp.asarray(xy[:, 0]),
                                                         jnp.asarray(xy[:, 1])))
    adcp = rng.normal(0.0, 0.05, (NB, 2))
    adcp[1] += 5.0  # instance 1 fails the gate
    eye = lambda m, s: np.eye(m) * s
    feats = _pixels(rng, np.asarray(mu.position) * 0.0, np.asarray(mu.orientation))
    jcam, tcam = JCam(), TCam()
    marker = (np.tile(np.eye(2) * 4.0, (4, 1, 1)), CORNERS, MARKER_P, MARKER_Q, np.eye(6) * 1e-3)
    return {
        "predict": (jpukf.predict, tpukf.predict, (None,), (DT,)),
        "acceleration": (jpukf.update_acceleration, tpukf.update_acceleration, (0, None), (acc, eye(3, 1e-4))),
        "velocity": (jpukf.update_velocity, tpukf.update_velocity, (0, None),
                     (rng.normal(0.0, 0.3, (NB, 3)), eye(3, 1e-3))),
        "pressure": (jpukf.update_pressure, tpukf.update_pressure, (0, None),
                     (np.asarray(params.atmospheric_pressure) + rng.normal(0.0, 100.0, (NB, 1)), eye(1, 2500.0))),
        "xy_position": (lambda s, p, z, r: jpukf.update_xy_position(s, p, z, r, jukf.D2P95),
                        lambda s, p, z, r: tpukf.update_xy_position(s, p, z, r, jukf.D2P95), (0, None),
                        (xy, eye(2, 0.25))),
        "water_velocity": (jpukf.update_water_velocity, tpukf.update_water_velocity, (0, None, None),
                           (adcp, eye(2, 1e-3), 0.3)),
        "body_efforts": (jpukf.update_body_efforts, tpukf.update_body_efforts, (0, None),
                         (rng.normal(0.0, 5.0, (NB, 6)), eye(6, 1.0))),
        "body_efforts_velocity_only": (
            functools.partial(jpukf.update_body_efforts, only_affect_velocity=True),
            functools.partial(tpukf.update_body_efforts, only_affect_velocity=True), (0, None),
            (rng.normal(0.0, 5.0, (NB, 6)), eye(6, 1.0))),
        "z_position": (jpukf.update_z_position, tpukf.update_z_position, (0, None),
                       (np.asarray(mu.position[:, 2:]) + rng.normal(0.0, 0.1, (NB, 1)), eye(1, 0.01))),
        "geographic_position": (jpukf.update_geographic_position, tpukf.update_geographic_position,
                                (0, 0, None, None), (lat, lon, eye(2, 0.25), np.array([0.2, -0.1, 0.4]))),
        "delayed_position": (jpukf.update_delayed_position, tpukf.update_delayed_position, (0, None, 0),
                             (rng.normal(0.0, 0.2, (NB, 2)), eye(2, 0.04), rng.normal(0.0, 0.2, (NB, 2)))),
        "visual_features": (
            lambda s, p, f, *a: jpukf.update_visual_features(s, p, f, *a, jcam, jnp.asarray(CAM_P),
                                                              jnp.asarray(CAM_Q)),
            lambda s, p, f, *a: tpukf.update_visual_features(s, p, f, *a, tcam, torch.tensor(CAM_P),
                                                              torch.tensor(CAM_Q)),
            (0, None, None, None, None, None), (feats, *marker)),
    }


_POSE_CASES = ["predict", "acceleration", "velocity", "pressure", "xy_position", "water_velocity", "body_efforts",
               "body_efforts_velocity_only", "z_position", "geographic_position", "delayed_position",
               "visual_features"]


@pytest.mark.parametrize("name", _POSE_CASES)
def test_vmapped_pose_function_matches_jax(pose_bank, name):
    """Each solo function that ``pose_driver.pose_step`` calls, vmapped over
    a bank of three (the gated ones with one instance outside the gate),
    against ``jax.vmap`` of the JAX function (jitted once)."""
    bs, params = pose_bank
    j_fn, t_fn, dims, args = _pose_cases(bs, params)[name]
    jdims = (0, None, *dims)
    jargs = tuple(a if isinstance(a, float) else jnp.asarray(a) for a in args)
    ref = jax.jit(jax.vmap(j_fn, in_axes=jdims))(jx(bs), jx(params), *jargs)
    targs = tuple(a if isinstance(a, float) else torch.tensor(np.asarray(a)) for a in args)
    out = tbank.vmap_filter(t_fn, data_axes=dims)(pt(bs), pt(params), *targs)
    _close(out, ref, name, **STEP)
    if name in ("xy_position", "water_velocity", "geographic_position"):
        gated = 1 if name == "water_velocity" else 0
        assert not bool(out[1].accepted[gated]) and int(out[1].accepted.sum()) == NB - 1


def test_vmapped_rotation_rate_and_augmented_delayed_fix(pose_bank):
    """The input cache (``integrate_rotation_rate``) and the 55-DOF
    augmented delayed fix (the state built by concatenation under vmap),
    against JAX's vmap."""
    bs, params = pose_bank
    rng = np.random.default_rng(1742)
    rr = rng.normal(0.0, 0.01, (NB, 3))
    out = torch.func.vmap(tpukf.integrate_rotation_rate)(pt(bs), torch.tensor(rr))
    assert torch.equal(out.rotation_rate, torch.tensor(rr))
    args = (rng.normal(0.0, 0.2, (NB, 2)), np.eye(2) * 0.04, rng.normal(0.0, 0.2, (NB, 2)), np.eye(2) * 0.09)
    dims = (0, None, 0, None)
    ref = jax.jit(jax.vmap(jpukf.update_delayed_position_with_augmentation, in_axes=(0, None, *dims)))(
        jx(bs), jx(params), *map(jnp.asarray, args))
    out = tbank.vmap_filter(tpukf.update_delayed_position_with_augmentation, data_axes=dims)(
        pt(bs), pt(params), *(torch.tensor(a) for a in args))
    _close(out, ref, **STEP)


def test_vmapped_pose_step_trajectory_matches_jax():
    """``torch.func.vmap(pose_driver.pose_step)`` at bank 4 over a
    1000-tick schedule (acceleration every tick, DVL 5 Hz, every instance
    its own readings and validity), against a JAX ``lax.scan`` of
    ``jax.vmap(pose_step)``."""
    state, params = mission_init()
    rng = np.random.default_rng(1750)
    n, t_len = 4, 1000
    bs = random_bank(rng, state, n, spread=0.1)
    g = float(jgeo.wgs84_gravity(0.822, 0.0))
    k = np.arange(t_len)[:, None]
    streams = dict(
        rotation_rate=rng.normal(0.0, 0.01, (t_len, n, 3)),
        acc=np.array([0.0, 0.0, g]) + rng.normal(0.0, 2e-3, (t_len, n, 3)), acc_cov=np.eye(3) * 4e-5,
        dvl=rng.normal(0.0, 0.05, (t_len, n, 3)), dvl_cov=np.eye(3) * 1e-3,
        dvl_valid=(k % 20 == 19) & (rng.uniform(size=(t_len, n)) < 0.9),
    )
    flat = {key: v.reshape(t_len * n, *v.shape[2:]) if v.ndim >= 2 and v.shape[:2] == (t_len, n) else v
            for key, v in streams.items()}
    inputs = jdrv.make_inputs(t_len * n, DT, **flat)
    absent = dict.fromkeys(("pressure", "pressure_cov", "pressure_valid", "xy", "xy_cov", "xy_valid", "adcp",
                            "adcp_cov", "adcp_cell_weighting", "adcp_valid", "efforts", "efforts_cov",
                            "efforts_valid"))
    inputs = np_tree(inputs._replace(**absent))
    inputs = jax.tree.map(lambda a: a.reshape(t_len, n, *a.shape[1:]), inputs)
    jp = jx(params)
    step = lambda s, i: jax.vmap(lambda a, b: jdrv.pose_step(a, jp, b))(s, i)
    ref_s, ref_o = jax.jit(lambda s, i: jax.lax.scan(step, s, i))(jx(bs), jx(inputs))
    tp = pt(params)
    vstep = tbank.vmap_tree(lambda s, i: tdrv.pose_step(s, tp, i), (0, 0))
    tin = pt(inputs)
    ts, outs = pt(bs), []
    cuda_lib.reset_launch_counts()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # bank 4: each op is too small to share out
    try:
        for tick in range(t_len):
            ts, out = vstep(ts, tdrv._tick(tin, tick))
            outs.append(out)
    finally:
        torch.set_num_threads(threads)
    assert all(kk.launches == 0 for kk in cuda_lib.KERNELS.values())
    assert_tree_close(ts, ref_s, **TRAJ, what="final state")
    np.testing.assert_allclose(torch.stack([o.position for o in outs]).numpy(), np.asarray(ref_o.position), **TRAJ)
    np.testing.assert_allclose(torch.stack([o.dvl_nis for o in outs]).numpy(), np.asarray(ref_o.dvl_nis),
                               rtol=1e-6, atol=1e-8)


def test_vmapped_marker_replay_runs_every_sighting_masked():
    """The solo replay ``run_trajectory`` under vmap with marker sightings
    that differ per instance: the flags cannot be read on the host there, so
    every tick runs the marker update masked. It matches the port's bank
    replay (which leaves the stream out of a tick with no sighting; held to
    JAX by ``tests/test_torch_pose_markers.py``) and its NIS is 0 off each
    instance's own sightings."""
    state, params = mission_init()
    rng = np.random.default_rng(1755)
    n, t_len = 3, 10
    bs = random_bank(rng, state, n, spread=0.1)
    g = float(jgeo.wgs84_gravity(0.822, 0.0))
    sighted = np.zeros((t_len, n), bool)
    sighted[4, 0] = sighted[8, 1] = sighted[4, 2] = sighted[9, 2] = True
    pos, q = np.asarray(bs.mu.position), np.asarray(bs.mu.orientation)
    feats = np.stack([_pixels(rng, pos - pos, q) for _ in range(t_len)])  # (T, n, 4, 2)
    rows = lambda a: torch.tensor(np.ascontiguousarray(a).reshape(t_len * n, *a.shape[2:]))
    inp = tdrv.make_inputs(t_len * n, DT, torch.zeros(t_len * n, 3, dtype=F64),
                           acc=rows(np.array([0.0, 0.0, g]) + rng.normal(0.0, 2e-3, (t_len, n, 3))),
                           acc_cov=torch.eye(3, dtype=F64) * 4e-5, marker_features=rows(feats),
                           marker_feature_covs=torch.tensor(np.tile(np.eye(2) * 4.0, (4, 1, 1))),
                           marker_valid=rows(sighted), device="cpu")
    lean = dict.fromkeys(("dvl", "dvl_cov", "dvl_valid", "pressure", "pressure_cov", "pressure_valid", "xy", "xy_cov",
                          "xy_valid", "adcp", "adcp_cov", "adcp_cell_weighting", "adcp_valid", "efforts",
                          "efforts_cov", "efforts_valid"))
    inp = tdrv.PoseInputs(*(None if x is None else x.reshape(t_len, n, *x.shape[1:]) for x in inp._replace(**lean)))
    t = lambda a: torch.tensor(np.asarray(a, np.float64))
    consts = tdrv.PoseStepConstants(gps_in_body=None, marker=tdrv.MarkerSetup(
        feature_positions=t(CORNERS), marker_position=t(MARKER_P), marker_orientation=t(MARKER_Q),
        cov_marker_pose=t(np.eye(6) * 1e-3), camera=TCam(), camera_in_imu_position=t(CAM_P),
        camera_in_imu_orientation=t(CAM_Q)))
    tp = pt(params)
    out_s, out_o = tbank.vmap_tree(lambda s, i: tdrv.run_trajectory(s, tp, i, consts), (0, 1))(pt(bs), inp)
    ref_s, ref_o = tdrv.run_trajectory_bank(pt(bs), tp, inp, consts)
    _close(out_s, np_tree(ref_s), **STEP)
    for name in ("position", "orientation", "cov_trace", "marker_nis"):
        np.testing.assert_allclose(getattr(out_o, name).transpose(0, 1).numpy(), getattr(ref_o, name).numpy(),
                                   **STEP, err_msg=name)
    nis = out_o.marker_nis.transpose(0, 1).numpy()  # (T, n, 4)
    assert np.all(nis[~sighted] == 0.0) and np.all(nis[sighted] > 0.0)


# ---------------------------------------------------------------------------
# the small filters: one vmapped solo step each
# ---------------------------------------------------------------------------


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_vmapped_velocity_ukf_solo_functions_match_jax():
    """``integrate_gyro``, ``integrate_body_efforts``, ``predict``,
    ``update_dvl`` and ``update_pressure`` of the VelocityUKF, each
    vmapped, against JAX's vmap."""
    rng = np.random.default_rng(1760)
    mu = jv.VelocityState(velocity=jnp.zeros(3), z_position=jnp.zeros(1))
    state, params = jv.init(mu, jnp.eye(4) * 0.1, jdyn.default_uwv_parameters())
    bs = np_tree(jbank.replicate(state, NB))
    g = rng.normal(size=(NB, 4, 4))
    bs = bs._replace(mu=bs.mu._replace(velocity=rng.normal(0.0, 0.5, (NB, 3))),
                     cov=0.02 * (g @ np.swapaxes(g, 1, 2) / 4 + np.eye(4)))
    rates, eff = rng.normal(0.0, 0.05, (NB, 3)), rng.normal(0.0, 30.0, (NB, 6))
    z_dvl, z_p = rng.normal(0.0, 0.5, (NB, 3)), rng.normal(0.0, 1.0, (NB, 1))

    def j_chain(s, rr, e, zd, zp):
        s = jv.predict(jv.integrate_body_efforts(jv.integrate_gyro(s, rr), e), params, 0.1)
        s, di = jv.update_dvl(s, zd, jnp.eye(3) * 0.01)
        s, pi = jv.update_pressure(s, zp, jnp.eye(1) * 0.04)
        return s, di, pi

    ref = jax.jit(jax.vmap(j_chain))(jx(bs), *map(jnp.asarray, (rates, eff, z_dvl, z_p)))
    tp = pt(np_tree(params))
    s = torch.func.vmap(tv.integrate_gyro)(pt(bs), torch.tensor(rates))
    s = torch.func.vmap(tv.integrate_body_efforts)(s, torch.tensor(eff))
    s = tbank.vmap_filter(tv.predict, data_axes=None)(s, tp, 0.1)
    r_dvl, r_p = torch.eye(3, dtype=F64) * 0.01, torch.eye(1, dtype=F64) * 0.04
    s, di = torch.func.vmap(tv.update_dvl, in_dims=(0, 0, None))(s, torch.tensor(z_dvl), r_dvl)
    s, pi = torch.func.vmap(tv.update_pressure, in_dims=(0, 0, None))(s, torch.tensor(z_p), r_p)
    _close((s, di, pi), ref, **STEP)


def test_vmapped_bottom_ukf_step_matches_jax():
    """The BottomUKF's ``predict``, ``update_range`` and ``update_normal``
    (the S² measurement mean under vmap), each vmapped, against JAX's vmap
    (its own bank forms are vmaps of these)."""
    rng = np.random.default_rng(1770)
    normals = _unit(rng.normal(size=(NB, 3)) * [0.2, 0.2, 1.0] + [0.0, 0.0, 0.5])
    g = rng.normal(size=(NB, 3, 3)) * 0.1
    bs = jb.BottomUKFState(mu=jb.BottomState(distance=12.0 + rng.normal(size=(NB, 1)), normal=normals),
                           cov=g @ np.swapaxes(g, 1, 2) + np.diag([0.5, 0.02, 0.02]),
                           velocity=rng.normal(0.0, 0.5, (NB, 3)))
    a = rng.normal(size=(3, 3)) * 0.3
    params = jb.BottomUKFParams(process_noise=a @ a.T + np.eye(3))
    beam, origin = _unit(np.array([0.1, 0.05, -0.99])), np.array([0.2, 0.0, -0.1])
    z_r = 11.7 + rng.normal(0.0, 0.3, (NB, 1))
    z_n = _unit(normals + rng.normal(0.0, 0.05, (NB, 3)))

    def j_step(s, zr, zn):
        s = jb.predict(s, jx(params), 0.1)
        s, ri = jb.update_range(s, zr, jnp.array([[0.04]]), jnp.asarray(beam), jnp.asarray(origin))
        s, ni = jb.update_normal(s, zn, jnp.eye(2) * 0.01)
        return s, ri, ni

    ref = jax.jit(jax.vmap(j_step))(jx(bs), jnp.asarray(z_r), jnp.asarray(z_n))
    tp = pt(params)
    s = torch.func.vmap(tb.predict, in_dims=(0, None, None))(pt(bs), tp, 0.1)
    s, ri = torch.func.vmap(tb.update_range, in_dims=(0, 0, None, None, None))(
        s, torch.tensor(z_r), torch.tensor([[0.04]], dtype=F64), torch.tensor(beam), torch.tensor(origin))
    s, ni = torch.func.vmap(tb.update_normal, in_dims=(0, 0, None))(s, torch.tensor(z_n),
                                                                     torch.eye(2, dtype=F64) * 0.01)
    _close((s, ri, ni), ref, **STEP)


def _indirect_bank(rng, nb=NB):
    params = np_tree(ji.init((0.05,) * 3, (0.02,) * 3, 30.0)[1])
    bs = ji.IndirectPoseUKFState(
        mu=ji.PoseErrorState(position_error=rng.normal(0.0, 0.2, (nb, 3)),
                             orientation_error=_quat_exp(rng.normal(0.0, 0.15, (nb, 3)))),
        cov=random_spd(rng, 6, nb, np.array([0.3, 0.2, 0.25, 0.05, 0.04, 0.06])),
        pose_ref_position=rng.normal(0.0, 0.5, (nb, 3)),
        pose_ref_orientation=_quat_exp(rng.normal(0.0, 0.1, (nb, 3))),
    )
    return bs, params


def test_vmapped_indirect_pose_ukf_step_matches_jax():
    """The IndirectPoseUKF's ``predict`` and a 4-corner ``update_markers``
    (each corner an S² update on the 12-DOF augmented state), vmapped,
    against JAX's vmap."""
    rng = np.random.default_rng(1780)
    bs, params = _indirect_bank(rng)
    feats = np.array([[300.0, 220.0], [340.0, 222.0], [338.0, 262.0], [302.0, 259.0]]) + rng.normal(
        0.0, 2.0, (NB, 4, 2))
    corners = np.array([[-0.15, -0.15, 0.0], [0.15, -0.15, 0.0], [0.15, 0.15, 0.0], [-0.15, 0.15, 0.0]])
    m_p, m_q = np.array([0.0, 0.0, 3.0]), np.array([1.0, 0.0, 0.0, 0.0])
    c_p, c_q = np.array([0.1, 0.0, 0.05]), np.array([1.0, 0.0, 0.0, 0.0])
    shared = (np.tile(np.eye(2) * 4.0, (4, 1, 1)), corners, m_p, m_q, np.eye(6) * 1e-3)
    jcam, tcam = JCam(), TCam()

    def j_step(s, f):
        s = ji.predict(s, jx(params), 0.1)
        return ji.update_markers(s, f, *map(jnp.asarray, shared), jcam, jnp.asarray(c_p), jnp.asarray(c_q))

    ref = jax.jit(jax.vmap(j_step))(jx(bs), jnp.asarray(feats))
    s = torch.func.vmap(ti.predict, in_dims=(0, None, None))(pt(bs), pt(params), 0.1)
    args = tuple(torch.tensor(a) for a in shared)
    out = tbank.vmap_tree(lambda st, f: ti.update_markers(st, f, *args, tcam, torch.tensor(c_p), torch.tensor(c_q)),
                          (0, 0))(s, torch.tensor(feats))
    _close(out, ref, **STEP)

"""The port's exported steps (``slam_uwv_kalman_filters_tpu_torch/utils/aot.py``)
and its kernels as ``torch.library`` ops, on the CPU, float64.

* ``tests/test_aot.py``'s two cases, mirrored: the port's generic step
  (``pose_ukf.predict`` then ``update_velocity``) exported, round-tripped
  through bytes and called equals the port's eager step bit for bit, matches
  the JAX package's own ``aot`` round trip of the same step to rtol 1e-10,
  and drives five chained calls to a finite state; the file round trip of
  the lanes prediction (K2).
* An export made before the step's first eager call (predict, then body
  efforts) leaves no fake tensor in the per-device masks that later eager
  calls read.
* A lanes tick (``set_rotation_rate_lanes`` + ``step_lanes``): its exported
  graph calls K5's op by name, it equals the eager tick bit for bit, and a
  call at another bank raises; an artifact whose header names the card
  refuses to load on a machine without one.
* ``torch.library.opcheck`` (schema and fake tensors) of every kernel op,
  on operands recorded from the port's entry points at banks of 3.
* The iterative mean polled (the eager loop) against run-all (what export
  and graph capture trace) bit for bit over a 1000-step BottomUKF generic
  trajectory, whose S² normal takes the mean.
"""

import io
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor

from slam_uwv_kalman_filters_tpu.models import pose_ukf as jpukf
from slam_uwv_kalman_filters_tpu.ops import dynamics as jdyn
from slam_uwv_kalman_filters_tpu.utils import aot as jaot
from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config as jconfig
from slam_uwv_kalman_filters_tpu_torch.models import bottom_fused as bf
from slam_uwv_kalman_filters_tpu_torch.models import bottom_ukf as bukf
from slam_uwv_kalman_filters_tpu_torch.models import indirect_fused as ifu
from slam_uwv_kalman_filters_tpu_torch.models import indirect_pose_ukf as iukf
from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
from slam_uwv_kalman_filters_tpu_torch.models import pose_marker_fused as pmf
from slam_uwv_kalman_filters_tpu_torch.models import pose_ukf as pukf
from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf
from slam_uwv_kalman_filters_tpu_torch.models import velocity_fused as vf
from slam_uwv_kalman_filters_tpu_torch.models import velocity_ukf as vukf
from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib, kernels
from slam_uwv_kalman_filters_tpu_torch.ops import dynamics as dyn
from slam_uwv_kalman_filters_tpu_torch.ops import manifolds as mf
from slam_uwv_kalman_filters_tpu_torch.parallel import bank
from slam_uwv_kalman_filters_tpu_torch.utils import aot
from slam_uwv_kalman_filters_tpu_torch.utils.config import CameraConfiguration, default_pose_ukf_config

from torch_parity import assert_tree_close, mission_init, pt, random_bank

F64 = torch.float64
NB = 3


def _filter():
    """tests/test_aot.py's filter on the port, on the CPU."""
    eye = torch.eye(3, dtype=F64)
    return pukf.init_from_pose(
        imu_in_nwu_pos=torch.zeros(3, dtype=F64), imu_in_nwu_pos_cov=eye * 0.01,
        imu_in_nwu_rot=torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=F64), imu_in_nwu_rot_cov=eye * 1e-4,
        config=default_pose_ukf_config(), model_parameters=dyn.default_uwv_parameters(device="cpu"),
        imu_delta_t=0.01, device="cpu",
    )


def _jax_filter():
    return jpukf.init_from_pose(
        imu_in_nwu_pos=jnp.zeros(3), imu_in_nwu_pos_cov=jnp.eye(3) * 0.01,
        imu_in_nwu_rot=jnp.array([1.0, 0, 0, 0]), imu_in_nwu_rot_cov=jnp.eye(3) * 1e-4,
        config=jconfig(), model_parameters=jdyn.default_uwv_parameters(), imu_delta_t=0.01,
    )


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(*(torch.utils._pytree.tree_leaves(t) for t in (a, b))))


def test_exported_step_round_trip():
    state, params = _filter()
    state = pukf.integrate_rotation_rate(state, torch.tensor([0.0, 0.0, 0.01], dtype=F64))
    z, r = torch.tensor([0.3, 0.0, 0.0], dtype=F64), torch.eye(3, dtype=F64) * 1e-3

    def step(s, zz):
        s = pukf.predict(s, params, 0.01)
        s, info = pukf.update_velocity(s, params, zz, r)
        return s, info.mahalanobis2

    blob = aot.serialize(aot.export_step(step, state, z))
    assert isinstance(blob, bytes) and len(blob) > 1000
    call = aot.deserialize(blob)
    ref_state, ref_nis = step(state, z)
    out_state, out_nis = call(state, z)
    assert type(out_state) is type(state) and type(out_state.mu) is type(state.mu)
    assert _equal(out_state, ref_state) and torch.equal(out_nis, ref_nis)

    # the JAX package's own round trip of the same step
    jstate, jparams = _jax_filter()
    jstate = jpukf.integrate_rotation_rate(jstate, jnp.array([0.0, 0.0, 0.01]))

    def jstep(s, zz):
        s = jpukf.predict(s, jparams, 0.01)
        s, info = jpukf.update_velocity(s, jparams, zz, jnp.eye(3) * 1e-3)
        return s, info.mahalanobis2

    jcall = jaot.deserialize(jaot.serialize(jaot.export_step(jstep, jstate, jnp.array([0.3, 0.0, 0.0]))))
    jref_state, jref_nis = jcall(jstate, jnp.array([0.3, 0.0, 0.0]))
    assert_tree_close(out_state, jref_state, rtol=1e-10, atol=1e-15, what="exported step")
    np.testing.assert_allclose(out_nis.numpy(), np.asarray(jref_nis), rtol=1e-10)

    # chained: the loaded step drives a short mission on its own
    s = state
    for _ in range(5):
        s, _ = call(s, z)
    assert bool(torch.isfinite(s.cov).all())


def test_export_before_the_first_eager_call_leaves_no_fake_tensor():
    """The per-device masks of Q (``pose_ukf._noise_masks``) and of the
    effort model's (x, y, ψ) block (``dynamics._xy_yaw_spread``) first built
    under export: the eager step after the export returns real tensors."""
    pukf._noise_masks.cache_clear()
    dyn._xy_yaw_spread.cache_clear()
    state, params = _filter()
    z = torch.tensor([10.0, 0.0, 0.0, 0.0, 0.0, 0.5], dtype=F64)
    r = torch.eye(6, dtype=F64) * 1e-2

    def step(s, zz):
        s = pukf.predict(s, params, 0.01)
        s, _ = pukf.update_body_efforts(s, params, zz, r)
        return s

    aot.export_step(step, state, z)
    leaves = torch.utils._pytree.tree_leaves(step(state, z))
    assert leaves and not any(isinstance(t, FakeTensor) for t in leaves)


def test_exported_file_round_trip(tmp_path):
    bstate, params = _lanes_bank(NB)

    def predict(ls):
        return pf.predict_lanes(ls, params, 0.01)

    ls = pf.to_lanes(bstate)
    path = str(tmp_path / "step.pt2")
    aot.save(path, aot.export_step(predict, ls))
    assert _equal(aot.load(path)(ls), predict(ls))


def _lanes_bank(nb, seed=11):
    state, params = mission_init()
    bstate = random_bank(np.random.default_rng(seed), state, nb, spread=0.1)
    return pt(bstate), pt(params)


def test_exported_lanes_tick_runs_k5_by_name_and_refuses_another_bank():
    bstate, params = _lanes_bank(NB)
    ls = pf.to_lanes(bstate)
    r_dvl, r_press = torch.eye(3, dtype=F64) * 1e-4, torch.eye(1, dtype=F64) * 2500.0
    aux = (params.atmospheric_pressure, 0.0, 0.0, 0.0)

    def tick(ls, rr, zv, zp):
        ls = pf.set_rotation_rate_lanes(ls, rr)
        ups = [puf.StepUpdate("velocity", zv, r_dvl), puf.StepUpdate("pressure", zp, r_press, None, aux)]
        return puf.step_lanes(ls, params, 0.01, ups)

    rng = np.random.default_rng(5)
    rr, zv = torch.as_tensor(rng.normal(0, 1e-3, (NB, 3))), torch.as_tensor(rng.normal(0, 0.3, (NB, 3)))
    zp = torch.as_tensor(101325.0 + rng.normal(0, 50, (NB, 1)))
    exported = aot.export_step(tick, ls, rr, zv, zp)
    targets = {str(n.target) for n in exported.program.graph.nodes if n.op == "call_function"}
    assert "slam_uwv.pose_step.default" in targets
    call = aot.deserialize(aot.serialize(exported))
    out_ls, out_infos = call(ls, rr, zv, zp)
    ref_ls, ref_infos = tick(ls, rr, zv, zp)
    assert type(out_ls) is pf.LanesBankState and len(out_infos) == 2
    assert _equal((out_ls, out_infos), (ref_ls, ref_infos))
    other = pf.to_lanes(_lanes_bank(NB + 1)[0])
    with pytest.raises(ValueError, match="the export takes"):
        call(other, *(torch.cat([x, x[:1]]) for x in (rr, zv, zp)))


def test_an_artifact_exported_on_the_card_refuses_a_machine_without_one(monkeypatch):
    state, params = _filter()
    blob = aot.serialize(aot.export_step(lambda s: pukf.integrate_rotation_rate(s, s.rotation_rate * 2), state))
    out = io.BytesIO()
    with zipfile.ZipFile(io.BytesIO(blob)) as src, zipfile.ZipFile(out, "w") as dst:
        for item in src.infolist():
            data = src.read(item)
            if item.filename.endswith("extra/slam_uwv_step.json"):
                data = json.dumps({**json.loads(data), "device": "cuda"}).encode()
            dst.writestr(item, data)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="exported on a CUDA device"):
        aot.deserialize(out.getvalue())


# ---------------------------------------------------------------------------
# every kernel op under opcheck
# ---------------------------------------------------------------------------

_OPS = {  # op name → (module, the module's KernelOp variable)
    "sigma_deltas_lanes": (kernels, "_SIGMA_DELTAS_LANES"), "sigma_deltas": (kernels, "_SIGMA_DELTAS"),
    "pose_predict": (pf, "_POSE_PREDICT"), "pose_update_model": (puf, "_POSE_UPDATE_MODEL"),
    "pose_update_tail": (puf, "_POSE_UPDATE_TAIL"), "pose_step": (puf, "_POSE_STEP"),
    "velocity_step": (vf, "_VELOCITY_STEP"), "bottom_step": (bf, "_BOTTOM_STEP"), "solve_spd": (kernels, "_SOLVE_SPD"),
    "indirect_predict": (ifu, "_INDIRECT_PREDICT"), "indirect_markers": (ifu, "_INDIRECT_MARKERS"),
    "pose_markers": (pmf, "_POSE_MARKERS"), "cholesky": (kernels, "_CHOLESKY"),
}


def _pose_calls():
    bstate, params = _lanes_bank(NB)
    ls = pf.to_lanes(bstate)
    rng = np.random.default_rng(7)
    z3 = torch.as_tensor(rng.normal(0, 0.3, (NB, 3)))
    zp = torch.as_tensor(101325.0 + rng.normal(0, 50, (NB, 1)))
    eye = lambda m: torch.eye(m, dtype=F64)
    bparams = bank.replicate(params, NB)
    h = pukf._h_pressure(torch.tensor(101325.0, dtype=F64), torch.zeros(3, dtype=F64))
    cam = CameraConfiguration()
    corners = torch.tensor([[0.15, 0.15, 0.0], [-0.15, 0.15, 0.0], [-0.15, -0.15, 0.0]], dtype=F64)
    pixels = torch.tensor([[330.0, 250.0], [310.0, 250.0], [310.0, 230.0]], dtype=F64)
    return [
        lambda: pf.predict_lanes(ls, params, 0.01),
        lambda: pf.predict_lanes(ls, bparams, 0.01),
        lambda: puf.update_model_lanes("velocity", ls, z3, eye(3) * 1e-3),
        lambda: puf.update_model_lanes("pressure", ls, zp, eye(1) * 2500.0,
                                       aux_bank=torch.full((NB, 1), 101325.0, dtype=F64)),
        lambda: puf.update_lanes(ls, params, zp, eye(1) * 2500.0, h, pukf._PRESSURE_DEPS),
        lambda: puf.step_lanes(ls, params, 0.01, [puf.StepUpdate("velocity", z3, eye(3) * 1e-3),
                                                  puf.StepUpdate("pressure", zp, eye(1) * 2500.0, None,
                                                                 (101325.0, 0.0, 0.0, 0.0))]),
        lambda: pmf.update_visual_features_lanes(
            ls, pixels, eye(2).expand(3, 2, 2) * 0.25, corners, torch.tensor([0.0, 0.0, -6.0], dtype=F64),
            torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=F64), eye(6) * 1e-6, cam, torch.zeros(3, dtype=F64),
            torch.tensor([0.0, 1.0, 0.0, 0.0], dtype=F64)),
    ]


def _small_filter_calls():
    model = dyn.default_uwv_parameters(device="cpu")
    vs, vparams = vukf.init(vukf.VelocityState(velocity=torch.tensor([0.5, 0.0, 0.0], dtype=F64),
                                               z_position=torch.tensor([-10.0], dtype=F64)),
                            torch.eye(4, dtype=F64) * 0.1, model)
    vls = vf.to_lanes(bank.replicate(vs, NB))
    bs, bparams = bukf.init(bukf.BottomState(distance=torch.tensor([8.0], dtype=F64),
                                             normal=torch.tensor([0.05, 0.0, 1.0], dtype=F64) / 1.00125),
                            torch.diag(torch.tensor([4.0, 0.05, 0.05], dtype=F64)))
    bls = bf.to_lanes(bank.replicate(bs, NB))
    ins, iparams = iukf.init(torch.full((3,), 1e-3, dtype=F64), torch.full((3,), 1e-4, dtype=F64), 60.0,
                             device="cpu")
    ils = ifu.to_lanes(bank.replicate(ins, NB))
    eye = lambda m: torch.eye(m, dtype=F64)
    corners = torch.tensor([[0.25, 0.25, 0.0], [-0.25, 0.25, 0.0]], dtype=F64)
    pixels = torch.tensor([[340.0, 260.0], [300.0, 260.0]], dtype=F64)
    down = torch.tensor([0.5, 0.0, -0.866], dtype=F64)
    return [
        lambda: vf.step_lanes(vls, vparams, 0.05, [vf.StepUpdate("dvl", torch.full((NB, 3), 0.4, dtype=F64),
                                                                 eye(3) * 1e-4),
                                                   vf.StepUpdate("pressure", torch.full((NB, 1), -10.0, dtype=F64),
                                                                 eye(1) * 1e-3, 3.84)]),
        lambda: bf.step_lanes(bls, bparams, 0.05, [bf.StepUpdate("range", torch.full((NB, 1), 9.0, dtype=F64),
                                                                 eye(1) * 1e-2, down, torch.zeros(3, dtype=F64)),
                                                   bf.StepUpdate("normal", torch.tensor([[0.0, 0.0, 1.0]] * NB,
                                                                                        dtype=F64), eye(2) * 1e-2)]),
        lambda: ifu.predict_lanes(ils, iparams, 0.5),
        lambda: ifu.update_markers_lanes(ils, pixels, eye(2).expand(2, 2, 2) * 0.25, corners,
                                         torch.tensor([0.0, 0.0, 6.0], dtype=F64),
                                         torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=F64), eye(6) * 1e-6,
                                         CameraConfiguration(), torch.zeros(3, dtype=F64),
                                         torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=F64)),
    ]


def _factor_calls():
    rng = np.random.default_rng(9)
    a = rng.normal(size=(NB, 20, 20))
    spd = torch.as_tensor(a @ a.transpose(0, 2, 1) + 20 * np.eye(20))
    return [
        lambda: kernels.sigma_deltas_banked(spd),
        lambda: kernels.solve_spd_banked(spd, torch.as_tensor(rng.normal(size=(NB, 20, 4)))),
        lambda: kernels.cholesky_banked(spd),
    ]


@pytest.fixture(scope="module")
def recorded_ops():
    """The arguments of each op's calls from the port's entry points, in the
    op's own types (each entry point's call taken through the op, as under
    export)."""
    calls = {name: [] for name in _OPS}
    patch = pytest.MonkeyPatch()
    for name, (module, var) in _OPS.items():
        kop = getattr(module, var)

        def recording(*op_args, _op=kop.op, _name=name):
            calls[_name].append(op_args)
            return _op(*op_args)

        patch.setattr(module, var, lambda *a, _kop=kop, _rec=recording: _kop.adapt(_rec, *a))
    try:
        for call in _pose_calls() + _small_filter_calls() + _factor_calls():
            call()
    finally:
        patch.undo()
    return calls


@pytest.mark.parametrize("name", sorted(_OPS))
def test_kernel_op_passes_opcheck(name, recorded_ops):
    module, var = _OPS[name]
    op = getattr(module, var).op
    assert str(op) == f"{cuda_lib.NAMESPACE}.{name}.default"
    assert recorded_ops[name], f"no entry point called {name}"
    for args in recorded_ops[name]:
        torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))


# ---------------------------------------------------------------------------
# the iterative mean: polled against run-all
# ---------------------------------------------------------------------------


def _bottom_trajectory(steps=1000):
    rng = np.random.default_rng(21)
    s, params = bukf.init(bukf.BottomState(distance=torch.tensor([8.0], dtype=F64),
                                           normal=torch.tensor([0.0, 0.0, 1.0], dtype=F64)),
                          torch.diag(torch.tensor([4.0, 0.05, 0.05], dtype=F64)))
    normal = np.array([0.05, 0.02, 1.0]) / np.linalg.norm([0.05, 0.02, 1.0])
    for k in range(steps):
        s = bukf.set_velocity(s, torch.tensor([0.5, 0.0, 0.0], dtype=F64))
        s = bukf.predict(s, params, 0.05)
        z = normal + rng.normal(scale=0.02, size=3)
        s, _ = bukf.update_normal(s, torch.as_tensor(z / np.linalg.norm(z)), torch.eye(2, dtype=F64) * 1e-3)
    return s


def test_iterative_mean_run_all_equals_polled_over_a_bottom_trajectory(monkeypatch):
    """The means of a polled 1000-step trajectory (the S² normal's and its
    measurement's, 2000 calls), each polled against run-all bit for bit: one
    in 10 at the trajectory's own shape (run-all against the mean the
    trajectory took), and all of them stacked along the batch axis (each
    instance masks its own iterations; a batch sums in another order than
    one instance, so there polled and run-all both run on the stack)."""
    calls = []
    polled_mean = mf._iterative_mean

    def recorded(vals, boxplus, boxminus, **kw):
        out = polled_mean(vals, boxplus, boxminus, **kw)
        calls.append((vals, boxplus, boxminus, kw, out))
        return out

    monkeypatch.setattr(mf, "_iterative_mean", recorded)
    final = _bottom_trajectory()
    monkeypatch.setattr(mf, "_iterative_mean", polled_mean)
    assert bool(torch.isfinite(final.cov).all()) and len(calls) == 2000
    groups = {}
    for vals, boxplus, boxminus, kw, _ in calls:
        groups.setdefault((boxplus, boxminus, tuple(sorted(kw.items()))), []).append(vals)
    stacked = {key: polled_mean(torch.stack(group, dim=1), key[0], key[1], **dict(key[2]))
               for key, group in groups.items()}
    monkeypatch.setattr(mf, "_run_every_iteration", lambda vals: True)
    for vals, boxplus, boxminus, kw, out in calls[::10]:
        assert torch.equal(polled_mean(vals, boxplus, boxminus, **kw), out)
    for key, group in groups.items():
        assert torch.equal(polled_mean(torch.stack(group, dim=1), key[0], key[1], **dict(key[2])), stacked[key])

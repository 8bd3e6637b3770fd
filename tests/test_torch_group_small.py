"""K6, the VelocityUKF step of ``csrc/velocity_step.cu``, and K9, the
IndirectPoseUKF predict of ``csrc/indirect_predict.cu``, against their plain
PyTorch versions. Each kernel picks its design from the bank: K6 predicts
with a group of 16 lanes an instance (``csrc/group_ukf.cuh``) up to 2048
instances and with one thread an instance past them (its update-only step
always one thread); K9 uses a group of 8 lanes up to 16 384 instances and
one thread past them.

The tests marked ``cuda`` run the kernels on the card and skip without one (a
CUDA kernel has no CPU mode): float32 and float64 at banks of 1, 7, 8, 9,
300, 600, 2200, 8192 and 20 000 (a K6 block holds 8 instances, a K9 block
16: banks 1, 7 and 9 leave every block ragged; 2200 lies past K6's switch,
20 000 past both), with NaN in the
covariance half no version reads. K6 for predict, update (DVL) and predict +
[DVL, pressure], instance 4's DVL a χ² outlier that is rejected with its
prior kept bit for bit; K9 on perturbed error states. Each design gives the
bits of the others on the same instances; pad lanes leave the bank's outputs
bit-identical and stay finite. Limits are the other card tests': float64
1e-9, float32 2e-3. ``tests/test_torch_cuda_kernels.py`` holds both kernels
to the bits of their one-thread design.

The other tests run on the CPU: each wrapper hands its kernel the operands'
own memory and allocates only the outputs (no scratch), a stand-in for the
kernel that computes the plain version through those pointers gives its
result, and a launch calls its dtype's entry point and counts. This file
imports no JAX:

    python -m pytest --noconftest tests/test_torch_group_small.py
"""

import ctypes

import numpy as np
import pytest
import torch
from test_torch_group_kernels import FakeLibrary, first_lanes, flat, nan_upper, rel
from test_torch_warp_predict import _lanes

from slam_uwv_kalman_filters_tpu_torch.models import indirect_fused as ifu
from slam_uwv_kalman_filters_tpu_torch.models import indirect_pose_ukf as ipu
from slam_uwv_kalman_filters_tpu_torch.models import velocity_fused as vf
from slam_uwv_kalman_filters_tpu_torch.models import velocity_ukf as vu
from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
from slam_uwv_kalman_filters_tpu_torch.ops import dynamics as dyn
from slam_uwv_kalman_filters_tpu_torch.ops import manifolds as mf
from slam_uwv_kalman_filters_tpu_torch.parallel import bank

LIMIT = {torch.float32: 2e-3, torch.float64: 1e-9}
BANKS = [1, 7, 8, 9, 300, 600, 2200, 8192, 20000]
LARGE = 20000  # past the bank at which each kernel switches design
CASES = ["predict", "update", "predict+dvl+pressure"]
OUTLIER = 4  # the instance whose DVL fails the χ²-95 gate


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def velocity_operands(nb, dtype, device, seed=0, pad=0):
    """K6 operands on a bank of VelocityUKF filters away from rest: moved
    means, correlated covariances (NaN in the unread half), efforts, gyro
    rates and tracker poses, a vehicle with live restoring terms; a DVL z
    that instance 4 (where the bank has it) fails the χ²-95 gate with, a
    depth z accepted. ``pad`` lanes in the JAX package's convention (identity
    covariances, copies of instance 0, neutral measurements). Returns {case:
    args}."""
    rng = np.random.default_rng(seed)
    f64 = torch.float64
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=f64)
    g = rng.normal(size=(nb, 4, 4))
    q = rng.normal(size=(nb, 4)) * [1.0, 0.2, 0.2, 0.4] + [2.0, 0.0, 0.0, 0.0]
    av = t(rng.normal(0.0, 0.05, (nb, 3)))
    state = vu.VelocityUKFState(
        vu.VelocityState(t(rng.normal(0.0, 0.5, (nb, 3))), t(rng.normal(0.0, 2.0, (nb, 1)))),
        t(0.02 * (g @ np.swapaxes(g, 1, 2) / 4 + np.eye(4))), t(rng.normal(0.0, 30.0, (nb, 6))), av,
        dyn.PoseVelocityState(t(rng.normal(size=(nb, 3))), t(q / np.linalg.norm(q, axis=1, keepdims=True)),
                              t(rng.normal(0.0, 0.5, (nb, 3))), av))
    lanes = nb + pad
    ls = vf.to_lanes(bank.tree_map(lambda x: x.to(dtype), state), lanes=lanes)
    ls = bank.tree_map(lambda x: x.to(device), ls._replace(cov_t=nan_upper(ls.cov_t)))
    model = bank.tree_map(lambda a: a.to(dtype), dyn.default_uwv_parameters(device=device))
    tt = lambda v: torch.tensor(v, dtype=dtype, device=device)
    model = model._replace(weight=tt(1000.0), cog=tt([0.01, -0.02, 0.05]), cob=tt([0.0, 0.01, -0.03]))
    scal = vf.params_block(vu.VelocityUKFParams(model, vu.default_process_noise(dtype, device)), 0.05, dtype)
    z = np.concatenate([state.mu.velocity.numpy() + 0.05, np.zeros((pad, 3))])
    if nb > OUTLIER:
        z[OUTLIER, 0] += 3.0
    depth = np.concatenate([state.mu.z_position.numpy() + 0.1, np.zeros((pad, 1))])
    eye = lambda m, v: torch.cat([torch.eye(m, dtype=dtype, device=device)[..., None].expand(m, m, nb) * v,
                                  torch.eye(m, dtype=dtype, device=device)[..., None].expand(m, m, pad)], -1)
    to = lambda a: torch.as_tensor(np.ascontiguousarray(a.T), device=device).to(dtype)
    dvl, prs = (to(z), eye(3, 0.01).contiguous(), 7.815), (to(depth), eye(1, 0.04).contiguous(), -1.0)
    base = (ls.cov_t, ls.mu_t, ls.eff_t, ls.av_t, ls.trk_t, scal)
    chain = lambda *ups: tuple(list(x) for x in zip(*ups)) if ups else ([], [], [])
    return {
        "predict": ((), True, *base, *chain()),
        "update": (("dvl",), False, *base, *chain(dvl)),
        "predict+dvl+pressure": (("dvl", "pressure"), True, *base, *chain(dvl, prs)),
    }


def indirect_predict_operands(nb, dtype, device, seed=0, lanes=None):
    """K9 operands on a bank of IndirectPoseUKF filters: moved error means
    (orientation errors up to ~0.3 rad), correlated covariances with NaN in
    the unread half, a shared process noise with cross terms, τ = 30 s, dt =
    0.1. ``lanes`` > nb pads in the JAX package's convention."""
    rng = np.random.default_rng(seed)
    f64 = torch.float64
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=f64)
    a = t(rng.normal(size=(nb, 6, 6))) * 0.1
    state = ipu.IndirectPoseUKFState(
        mu=ipu.PoseErrorState(t(rng.normal(size=(nb, 3))) * 0.2, mf.quat_exp(t(rng.normal(size=(nb, 3))) * 0.15)),
        cov=a @ a.transpose(1, 2) + torch.diag(t([0.05, 0.04, 0.06, 0.003, 0.002, 0.004])),
        pose_ref_position=t(rng.normal(size=(nb, 3))) * 0.5,
        pose_ref_orientation=mf.quat_exp(t(rng.normal(size=(nb, 3))) * 0.1))
    _, params = ipu.init((0.05,) * 3, (0.02,) * 3, 30.0, dtype=f64, device="cpu")
    qa = t(rng.normal(size=(6, 6))) * 0.01
    params = params._replace(process_noise=params.process_noise + qa @ qa.T)
    ls = ifu.to_lanes(bank.tree_map(lambda x: x.to(dtype), state), lanes=lanes)
    scal = ifu.predict_scalars(bank.tree_map(lambda x: x.to(dtype), params), 0.1, dtype)
    return tuple(x.to(device) for x in (nan_upper(ls.cov_t), ls.mu_t, scal))


def _check_k6(ko, po, args, dtype, nb, case):
    assert all(bool(torch.isfinite(x).all()) for x in ko[:3])
    assert max(rel(k, p) for k, p in zip(ko[:3], po[:3])) <= LIMIT[dtype]
    for (km2, kacc, knu), (pm2, pacc, pnu) in zip(ko[3], po[3]):
        assert torch.equal(kacc, pacc)
        assert max(rel(km2, pm2), rel(knu, pnu)) <= LIMIT[dtype]
    if "dvl" in case or case == "update":
        acc = ko[3][0][1][0]
        assert int(acc.sum()) == nb - (nb > OUTLIER)
        if nb > OUTLIER:  # the outlier rejected
            assert acc[OUTLIER] == 0.0
            if case == "update":  # its prior kept bit for bit
                cov_t, mu_t = args[2], args[3]
                assert torch.equal(torch.tril(ko[0][..., OUTLIER].T), torch.tril(torch.nan_to_num(cov_t[..., OUTLIER].T)))
                assert torch.equal(ko[1][:, OUTLIER], mu_t[:, OUTLIER])


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("nb", BANKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k6_matches_plain(device, dtype, nb, case):
    args = velocity_operands(nb, dtype, device, seed=nb)[case]
    k6 = cuda_lib.KERNELS["velocity_step"]
    before = k6.launches
    ko = vf.velocity_step_lanes_cuda(*args)
    torch.cuda.synchronize()
    assert k6.launches == before + 1
    _check_k6(ko, vf.velocity_step_lanes_plain(*args), args, dtype, nb, case)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", BANKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k9_matches_plain(device, dtype, nb):
    args = indirect_predict_operands(nb, dtype, device, seed=nb)
    k9 = cuda_lib.KERNELS["indirect_predict"]
    before = k9.launches
    ko = ifu.indirect_predict_lanes_cuda(*args)
    torch.cuda.synchronize()
    assert k9.launches == before + 1
    po = ifu.indirect_predict_lanes_plain(*args)
    assert all(bool(torch.isfinite(x).all()) for x in ko)
    assert max(rel(ko[0], po[0]), rel(ko[1], po[1])) <= LIMIT[dtype]
    assert torch.equal(ko[0], ko[0].transpose(0, 1))  # both halves written, alike


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [7, 300, 2000, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_designs_give_the_same_bits(device, dtype, nb):
    """Each kernel's design at bank ``nb`` gives the bits of its design at
    20 000 on the same instances, the first ``nb`` of a bank of 20 000."""
    calls = {f"velocity_step[{case}]": (vf.velocity_step_lanes_cuda, args)
             for case, args in velocity_operands(LARGE, dtype, device, seed=nb).items()}
    calls["indirect_predict"] = (ifu.indirect_predict_lanes_cuda, indirect_predict_operands(LARGE, dtype, device,
                                                                                           seed=nb))
    for name, (fn, args) in calls.items():
        large = flat(fn(*args))
        small = flat(fn(*first_lanes(args, LARGE, nb)))
        torch.cuda.synchronize()
        differ = [int((a[..., :nb] != b).sum()) for a, b in zip(large, small)]
        assert not any(differ), (name, differ)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [7, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pad_lanes_leave_the_bank_alone(device, dtype, nb):
    """28 pad lanes (identity covariances, copies of instance 0, neutral
    measurements) leave each kernel's outputs on the bank bit-identical and
    stay finite."""
    pairs = {f"velocity_step[{case}]": (vf.velocity_step_lanes_cuda, args,
                                        velocity_operands(nb, dtype, device, seed=nb, pad=28)[case])
             for case, args in velocity_operands(nb, dtype, device, seed=nb).items()}
    pairs["indirect_predict"] = (ifu.indirect_predict_lanes_cuda,
                                 indirect_predict_operands(nb, dtype, device, seed=nb),
                                 indirect_predict_operands(nb, dtype, device, seed=nb, lanes=nb + 28))
    for name, (fn, args, padded) in pairs.items():
        ko, kp = flat(fn(*args)), flat(fn(*padded))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b[..., :nb]) for a, b in zip(ko, kp)), name
        assert all(bool(torch.isfinite(b[..., nb:]).all()) for b in kp), name


# ---------------------------------------------------------------------------
# the wrappers' operands, on the CPU, against a stand-in for the kernel
# ---------------------------------------------------------------------------

MODEL_NAME = {i: name for name, i in vf.MODEL_ID.items()}


class StandIn:
    """Records each launch and computes the kernel's function, as its C
    interface defines it, through the pointers (and, for K6, the host
    arrays of its chain) it was given."""

    def __init__(self, name):
        self.name, self.calls = name, []

    def __call__(self, dtype, *args):
        self.calls.append(args)
        if self.name == "velocity_step":
            (do_predict, cov, mu, eff, av, trk, scal, n, models_a, z_a, r_a, thr_a, m2_a, acc_a, nu_a,
             cov_out, mu_out, trk_out, nb, _) = args
            host = lambda ctype, addr: list((ctype * max(1, n)).from_address(addr))[:n]
            models = tuple(MODEL_NAME[i] for i in host(ctypes.c_int, models_a))
            ms = [len(vf.FUSED_MODELS[model]) for model in models]
            ptrs = lambda addr: host(ctypes.c_void_p, addr)
            ref = vf.velocity_step_lanes_plain(
                models, bool(do_predict), _lanes(cov, dtype, 4, 4, nb), _lanes(mu, dtype, 4, nb),
                _lanes(eff, dtype, 6, nb), _lanes(av, dtype, 3, nb), _lanes(trk, dtype, 13, nb),
                _lanes(scal, dtype, 165, 1), [_lanes(p, dtype, m, nb) for p, m in zip(ptrs(z_a), ms)],
                [_lanes(p, dtype, m, m, nb) for p, m in zip(ptrs(r_a), ms)], host(ctypes.c_double, thr_a))
            outs = [(_lanes(cov_out, dtype, 4, 4, nb), ref[0]), (_lanes(mu_out, dtype, 4, nb), ref[1]),
                    (_lanes(trk_out, dtype, 13, nb), ref[2])]
            for p2, pa, pn, m, info in zip(ptrs(m2_a), ptrs(acc_a), ptrs(nu_a), ms, ref[3]):
                outs += [(_lanes(p2, dtype, 1, nb), info[0]), (_lanes(pa, dtype, 1, nb), info[1]),
                         (_lanes(pn, dtype, m, nb), info[2])]
        else:
            cov, mu, scal, cov_out, mu_out, nb, _ = args
            ref = ifu.indirect_predict_lanes_plain(_lanes(cov, dtype, 6, 6, nb), _lanes(mu, dtype, 7, nb),
                                                   _lanes(scal, dtype, 38))
            outs = zip((_lanes(cov_out, dtype, 6, 6, nb), _lanes(mu_out, dtype, 7, nb)), ref)
        for o, x in outs:
            o.copy_(x)


def _hand_over(monkeypatch, name):
    """Stand in for kernel ``name`` and record what the wrapper allocates
    before its launch."""
    fake, allocated, at_launch = StandIn(name), [], []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: allocated.append(empty(*a, **kw)) or allocated[-1])
    monkeypatch.setattr(cuda_lib.KERNELS[name], "launch",
                        lambda *a, **kw: at_launch.extend(t.data_ptr() for t in allocated) or fake(*a, **kw))
    monkeypatch.setattr(cuda_lib, "stream_ptr", lambda device: None)
    return fake, at_launch


@pytest.mark.parametrize("case", CASES)
def test_k6_wrapper_hands_the_kernel_its_operands_and_no_scratch(monkeypatch, case):
    args = velocity_operands(9, torch.float64, "cpu", seed=1)[case]
    fake, at_launch = _hand_over(monkeypatch, "velocity_step")
    out = vf.velocity_step_lanes_cuda(*args)
    (call,) = fake.calls
    assert len(call) == 20  # the chain's host arrays, 3 outputs, bank, stream: no scratch
    assert call[1:6] == tuple(t.data_ptr() for t in args[2:7])  # cov, mu, eff, av, trk in place
    assert call[6] == (args[7].data_ptr() if args[1] else None)  # the parameter block, read only to predict
    host = lambda ctype, addr: list((ctype * max(1, call[7])).from_address(addr))[:call[7]]
    assert host(ctypes.c_void_p, call[9]) == [t.data_ptr() for t in args[8]]  # each z in place
    assert host(ctypes.c_void_p, call[10]) == [t.data_ptr() for t in args[9]]  # each R in place
    outs = flat(out)
    assert [call[15], call[16], call[17]] + [p for a in (12, 13, 14) for p in host(ctypes.c_void_p, call[a])] == [
        outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(), *(x.data_ptr() for x in outs[3::3]),
        *(x.data_ptr() for x in outs[4::3]), *(x.data_ptr() for x in outs[5::3])]
    assert call[18] == 9
    assert sorted(at_launch) == sorted(x.data_ptr() for x in outs)  # only the outputs
    for o, p in zip(outs, flat(vf.velocity_step_lanes_plain(*args))):
        torch.testing.assert_close(o, p, rtol=0, atol=0, equal_nan=True)


def test_k9_wrapper_hands_the_kernel_its_operands_and_no_scratch(monkeypatch):
    args = indirect_predict_operands(5, torch.float64, "cpu", seed=2)
    fake, at_launch = _hand_over(monkeypatch, "indirect_predict")
    out = ifu.indirect_predict_lanes_cuda(*args)
    (call,) = fake.calls
    assert len(call) == 7  # 3 operands, 2 outputs, bank, stream: no scratch
    assert call[:3] == tuple(t.data_ptr() for t in args) and call[5] == 5
    assert call[3:5] == tuple(t.data_ptr() for t in out) == tuple(at_launch)  # only the outputs
    for o, p in zip(out, ifu.indirect_predict_lanes_plain(*args)):
        torch.testing.assert_close(o, p, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("name", ["velocity_step", "indirect_predict"])
def test_a_launch_calls_its_dtypes_entry_and_counts(monkeypatch, name):
    """Each dtype launches through its own entry point, the design picked
    inside it; a launch counts once it returned success, and a failed one
    raises without counting."""
    kernel, lib = cuda_lib.KERNELS[name], FakeLibrary()
    monkeypatch.setattr(cuda_lib, "library", lambda: lib)
    before = kernel.launches
    kernel.launch(torch.float32, 1, 2)
    kernel.launch(torch.float64, 3)
    assert lib.calls == [(f"{kernel.symbol}_f32", (1, 2)), (f"{kernel.symbol}_f64", (3,))]
    assert kernel.launches == before + 2
    monkeypatch.setattr(cuda_lib, "library", lambda: FakeLibrary(rc=9))
    with pytest.raises(RuntimeError, match="cudaError 9"):
        kernel.launch(torch.float32, 4)
    assert kernel.launches == before + 2
    lib = FakeLibrary(rc=4)  # the warps of the design a bank picks, read without a launch
    monkeypatch.setattr(cuda_lib, "library", lambda: lib)
    assert kernel.warps_per_block(torch.float32, 65536) == 4 and kernel.resident_warps(torch.float64, 1) == 4
    assert lib.calls == [(f"{kernel.symbol}_f32_warps", (65536,)), (f"{kernel.symbol}_f64_resident", (1,))]
    assert kernel.launches == before + 2


def test_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch):
    """An update chain past MAX_STEP_UPDATES, or an operand of the wrong
    shape, raise before any launch."""
    fake6, _ = _hand_over(monkeypatch, "velocity_step")
    args = velocity_operands(3, torch.float64, "cpu", seed=3)["predict+dvl+pressure"]
    with pytest.raises(ValueError, match="MAX_STEP_UPDATES"):
        vf.velocity_step_lanes_cuda(("dvl",) * 9, *args[1:])
    with pytest.raises(ValueError, match="expected"):
        vf.velocity_step_lanes_cuda(args[0], args[1], args[2][..., :2], *args[3:])
    fake9, _ = _hand_over(monkeypatch, "indirect_predict")
    ops = indirect_predict_operands(3, torch.float64, "cpu", seed=3)
    with pytest.raises(ValueError, match="expected"):
        ifu.indirect_predict_lanes_cuda(ops[0][..., :2], *ops[1:])
    with pytest.raises(ValueError, match="expected"):
        ifu.indirect_predict_lanes_cuda(*ops[:2], ops[2][:30])
    assert not fake6.calls and not fake9.calls

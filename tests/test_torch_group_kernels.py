"""K7, the BottomUKF step of ``csrc/bottom_step.cu``, and K10, the
IndirectPoseUKF marker update of ``csrc/indirect_markers.cu``, against their
plain PyTorch versions. Each kernel has two designs and picks one from the
bank: K7 a group of 8 lanes an instance (``csrc/group_ukf.cuh``) up to
16 384 instances and one thread an instance past them; K10 a group of 32
lanes up to 4096 instances and of 4 past them.

The tests marked ``cuda`` run the kernels on the card and skip without one (a
CUDA kernel has no CPU mode): float32 and float64 at banks of 1, 7, 8, 9,
300, 600, 2200 and 20 000 (both designs of both kernels; a K7 block holds 16
or 128 instances, a K10 block 4 or 16: banks 1, 7 and 9 leave every block
ragged), with NaN in the covariance half no version reads. K7 for predict,
range, normal and predict + range + normal, instance 4's range a χ²
outlier that is rejected with its prior kept bit for bit; K10 with 1 and 4
corners, shared and per-instance marker data; both designs give the same
bits; pad lanes leave both banks' outputs bit-identical and stay finite.
Limits are the other card tests': float64 1e-9, float32 2e-3, and for K10
chip_smoke.py's MARKER_LIMITS (2.1e-3 in float32).
``tests/test_torch_cuda_kernels.py`` holds both kernels to the bits of
their one-thread design.

The other tests run on the CPU: each wrapper hands its kernel the operands'
own memory and allocates only the outputs (no scratch), a stand-in for the
kernel that computes the plain version through those pointers gives its
result, and a launch calls its dtype's entry point and counts. This file
imports no JAX:

    python -m pytest --noconftest tests/test_torch_group_kernels.py
"""

import ctypes

import numpy as np
import pytest
import torch
from test_torch_warp_predict import _lanes

from slam_uwv_kalman_filters_tpu_torch.models import bottom_fused as bf
from slam_uwv_kalman_filters_tpu_torch.models import indirect_fused as ifu
from slam_uwv_kalman_filters_tpu_torch.models import indirect_pose_ukf as ipu
from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
from slam_uwv_kalman_filters_tpu_torch.ops import manifolds as mf
from slam_uwv_kalman_filters_tpu_torch.parallel import bank
from slam_uwv_kalman_filters_tpu_torch.utils.config import CameraConfiguration

LIMIT = {torch.float32: 2e-3, torch.float64: 1e-9}
MARKER_LIMIT = {torch.float32: 2.1e-3, torch.float64: 1e-9}
BANKS = [1, 7, 8, 9, 300, 600, 2200, 20000]
LARGE = 20000  # past the bank at which each kernel switches design
CASES = ["predict", "range", "normal", "predict+range+normal"]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def rel(a, b):
    return ((a - b).abs() / (1 + b.abs())).max().item()


def flat(outputs):
    """A kernel's output tensors in order (K7's per-update infos unpacked)."""
    return [x for y in outputs for x in (flat(y) if isinstance(y, (list, tuple)) else [y])]


def nan_upper(cov_t):
    """NaN at [c, r < c] of a lanes covariance, the half no version reads."""
    n = cov_t.shape[0]
    upper = torch.tril(torch.ones(n, n, dtype=torch.bool, device=cov_t.device), -1)[..., None]
    return torch.where(upper, float("nan"), cov_t).contiguous()


def _unit(v):
    v = np.asarray(v, dtype=np.float64)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def bottom_operands(nb, dtype, device, seed=0, pad=0):
    """K7 operands on a bank of BottomUKF filters: correlated covariances
    (NaN in the unread half), velocities, normals tilted at random and, where
    the bank has them, one 1e-3 off the pole and two at x₂ = ±1e-3 (where the
    basis changes sides); a range whose instance 4 is 500 m out (χ²(1) gate
    3.841) and an S² normal observation (gate 5.991). ``pad`` lanes in the
    JAX package's convention (identity covariances, copies of instance 0).
    Returns {case: args}."""
    rng = np.random.default_rng(seed)
    normals = _unit(rng.normal(size=(nb, 3)) * 0.2 + [0.0, 0.0, 1.0])
    for i, v in enumerate(([1e-3, -2e-3, 1.0], [0.3, 0.2, 1e-3], [0.3, -0.2, -1e-3])[:nb]):
        normals[i] = _unit(v)
    g = rng.normal(size=(nb, 3, 3)) * 0.1
    cov = g @ np.swapaxes(g, 1, 2) + np.diag([0.5, 0.02, 0.02])
    dist = 12.0 + rng.normal(size=(nb, 1))
    vel = rng.normal(0.0, 0.5, (nb, 3))
    beam = _unit(rng.normal(size=(nb, 3)) * [0.2, 0.2, 0.1] + [0.0, 0.0, -1.0])
    org = rng.normal(0.0, 0.1, (nb, 3))
    z = (np.einsum("bi,bi->b", np.concatenate([np.zeros((nb, 2)), -dist], 1) - org, normals)
         / np.einsum("bi,bi->b", beam, normals) + rng.normal(0.0, 0.05, nb))
    if nb > 4:
        z[4] += 500.0
    zn = _unit(normals + rng.normal(0.0, 0.05, (nb, 3)))
    padded = lambda a, fill: np.concatenate([a, np.broadcast_to(fill, (pad, *a.shape[1:]))])
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)
    lanes = nb + pad
    cov_t = nan_upper(t(np.transpose(padded(cov, np.eye(3)), (2, 1, 0))))
    mu_t = t(padded(np.concatenate([dist, normals], 1), np.concatenate([dist[0], normals[0]])).T)
    vel_t = t(padded(vel, vel[0]).T)
    eye = lambda m, v: (torch.eye(m, dtype=dtype, device=device) * v)[..., None].expand(m, m, lanes).contiguous()
    qa = rng.normal(size=(3, 3)) * 0.3
    q9 = tuple((qa @ qa.T + np.eye(3)).reshape(9).tolist())
    base = (cov_t, mu_t, vel_t, 0.1, q9)
    rng_ops = ([t(padded(z, 0.0)[None])], [eye(1, 0.04)], [t(padded(beam, [0.0, 0.0, -1.0]).T)],
               [t(padded(org, 0.0).T)], [3.841])
    nrm_ops = ([t(padded(zn, [0.0, 0.0, 1.0]).T)], [eye(2, 0.01)], [None], [None], [5.991])
    return {
        "predict": ((), True, *base, [], [], [], [], []),
        "range": (("range",), False, *base, *rng_ops),
        "normal": (("normal",), False, *base, *nrm_ops),
        "predict+range+normal": (("range", "normal"), True, *base, *(a + b for a, b in zip(rng_ops, nrm_ops))),
    }


def indirect_operands(nb, dtype, device, k, per_instance, seed=0, lanes=None):
    """K10 operands on a bank of IndirectPoseUKF filters (moved error means,
    orientation errors up to ~0.3 rad, correlated covariances with NaN in the
    unread half, pose references) and k corners of a marker 3 m ahead seen
    from ref ∘ a true bias with 1 px of noise: shared pixels and marker pose,
    or per instance. ``lanes`` > nb pads in the JAX package's convention."""
    f64 = torch.float64
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=f64)
    a = t(rng.normal(size=(nb, 6, 6))) * 0.1
    state = ipu.IndirectPoseUKFState(
        mu=ipu.PoseErrorState(t(rng.normal(size=(nb, 3))) * 0.2, mf.quat_exp(t(rng.normal(size=(nb, 3))) * 0.15)),
        cov=a @ a.transpose(1, 2) + torch.diag(t([0.05, 0.04, 0.06, 0.003, 0.002, 0.004])),
        pose_ref_position=t(rng.normal(size=(nb, 3))) * 0.5,
        pose_ref_orientation=mf.quat_exp(t(rng.normal(size=(nb, 3))) * 0.1))
    corners = t([[-0.15, -0.15, 0.0], [0.15, -0.15, 0.0], [0.15, 0.15, 0.0], [-0.15, 0.15, 0.0]][:k])
    mpos, mrot = t([0.3, -0.2, 3.0]), mf.quat_exp(t([0.02, -0.05, 0.1]))
    if per_instance:
        mpos = mpos + t(rng.normal(size=(nb, 3))) * 0.05
        mrot = mf.so3_boxplus(mrot.expand(nb, 4), t(rng.normal(size=(nb, 3))) * 0.02)
    cam_p, cam_q, cam = t([0.1, 0.0, 0.05]), mf.quat_exp(t([0.01, -0.02, 0.03])), CameraConfiguration()
    qi, pi = mf.affine_inv(*mf.affine_mul(state.pose_ref_orientation, state.pose_ref_position + t([0.1, -0.05, 0.08]),
                                          cam_q, cam_p))
    f_cam = mf.affine_apply(qi[:, None], pi[:, None], mf.affine_apply(mrot[..., None, :], mpos[..., None, :], corners))
    px = torch.stack([cam.fx * f_cam[..., 0] / f_cam[..., 2] + cam.cx, cam.fy * f_cam[..., 1] / f_cam[..., 2] + cam.cy],
                     -1) + t(rng.normal(size=(nb, k, 2)))
    ls = ifu.to_lanes(bank.tree_map(lambda x: x.to(dtype), state), lanes=lanes)
    ls = bank.tree_map(lambda x: x.to(device), ls._replace(cov_t=nan_upper(ls.cov_t)))
    dev = lambda x: x.to(device)
    return ifu.marker_operands(ls, dev(px if per_instance else px[0]), dev(4.0 * torch.eye(2, dtype=f64)),
                               dev(corners), dev(mpos), dev(mrot), dev(1e-3 * torch.eye(6, dtype=f64)), cam,
                               dev(cam_p), dev(cam_q), nb=nb)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("nb", BANKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k7_matches_plain(device, dtype, nb, case):
    args = bottom_operands(nb, dtype, device, seed=nb)[case]
    k7 = cuda_lib.KERNELS["bottom_step"]
    before = k7.launches
    ko = bf.bottom_step_lanes_cuda(*args)
    torch.cuda.synchronize()
    assert k7.launches == before + 1
    po = bf.bottom_step_lanes_plain(*args)
    assert bool(torch.isfinite(ko[0]).all()) and bool(torch.isfinite(ko[1]).all())
    assert max(rel(ko[0], po[0]), rel(ko[1], po[1])) <= LIMIT[dtype]
    for (km2, kacc, knu), (pm2, pacc, pnu) in zip(ko[2], po[2]):
        assert torch.equal(kacc, pacc)
        assert max(rel(km2, pm2), rel(knu, pnu)) <= LIMIT[dtype]
    if "range" in case and nb > 4:  # instance 4 rejected, the rest accepted
        acc = ko[2][0][1][0]
        assert acc[4] == 0.0 and int(acc.sum()) == nb - 1
        if case == "range":  # its prior kept bit for bit
            cov_t, mu_t = args[2], args[3]
            assert torch.equal(torch.tril(ko[0][..., 4].T), torch.tril(torch.nan_to_num(cov_t[..., 4].T)))
            assert torch.equal(ko[1][:, 4], mu_t[:, 4])


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [7, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k7_pad_lanes_leave_the_bank_alone(device, dtype, nb):
    args = bottom_operands(nb, dtype, device, seed=nb)["predict+range+normal"]
    padded = bottom_operands(nb, dtype, device, seed=nb, pad=28)["predict+range+normal"]
    ko, kp = bf.bottom_step_lanes_cuda(*args), bf.bottom_step_lanes_cuda(*padded)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b[..., :nb]) for a, b in zip(flat(ko), flat(kp)))
    assert all(bool(torch.isfinite(b[..., nb:]).all()) for b in flat(kp))


@pytest.mark.cuda
@pytest.mark.parametrize("k,per_instance", [(1, False), (1, True), (4, False), (4, True)])
@pytest.mark.parametrize("nb", BANKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k10_matches_plain(device, dtype, nb, k, per_instance):
    args = indirect_operands(nb, dtype, device, k, per_instance, seed=nb)
    k10 = cuda_lib.KERNELS["indirect_markers"]
    before = k10.launches
    ko = ifu.indirect_markers_lanes_cuda(*args)
    torch.cuda.synchronize()
    assert k10.launches == before + 1
    po = ifu.indirect_markers_lanes_plain(*args)
    assert all(bool(torch.isfinite(x).all()) for x in ko)
    d = torch.diagonal(torch.nan_to_num(args[0]), dim1=0, dim2=1).T.abs()
    cov_err = ((ko[0] - po[0]).abs() / torch.sqrt(d[:, None] * d[None, :])).max().item()
    assert cov_err <= MARKER_LIMIT[dtype]  # normalized by the prior
    assert max(rel(ko[i], po[i]) for i in (1, 2, 3)) <= MARKER_LIMIT[dtype]


def first_lanes(args, nb, n):
    """A kernel's operands with each tensor of bank ``nb`` cut to its first
    ``n`` instances."""
    if isinstance(args, (list, tuple)):
        return type(args)(first_lanes(a, nb, n) for a in args)
    if isinstance(args, torch.Tensor) and args.shape[-1] == nb:
        return args[..., :n].contiguous()
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [7, 300, 2000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_group_sizes_give_the_same_bits(device, dtype, nb):
    """Each kernel's small-bank design at bank ``nb`` gives the bits of its
    large-bank design on the same instances, the first ``nb`` of a bank of
    20 000."""
    calls = {"bottom_step": (bf.bottom_step_lanes_cuda,
                             bottom_operands(LARGE, dtype, device, seed=nb)["predict+range+normal"]),
             "indirect_markers": (ifu.indirect_markers_lanes_cuda,
                                  indirect_operands(LARGE, dtype, device, 4, True, seed=nb))}
    for name, (fn, args) in calls.items():
        large = flat(fn(*args))
        small = flat(fn(*first_lanes(args, LARGE, nb)))
        torch.cuda.synchronize()
        differ = [int((a[..., :nb] != b).sum()) for a, b in zip(large, small)]
        assert not any(differ), (name, differ)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [7, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k10_pad_lanes_leave_the_bank_alone(device, dtype, nb):
    """28 pad lanes (identity covariance, copies of instance 0's means, pad
    corners from ``indirect_fused``) leave the bank's outputs bit-identical
    and stay finite."""
    plain_bank = ifu.indirect_markers_lanes_cuda(*indirect_operands(nb, dtype, device, 4, True, seed=nb))
    padded = ifu.indirect_markers_lanes_cuda(*indirect_operands(nb, dtype, device, 4, True, seed=nb, lanes=nb + 28))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b[..., :nb]) for a, b in zip(plain_bank, padded))
    assert all(bool(torch.isfinite(b[..., nb:]).all()) for b in padded)


# ---------------------------------------------------------------------------
# the wrappers' operands, on the CPU, against a stand-in for the kernel
# ---------------------------------------------------------------------------

MODEL_NAME = {i: name for name, i in bf.MODEL_ID.items()}


class StandIn:
    """Records each launch and computes the kernel's function, as its C
    interface defines it, through the pointers (and, for K7, the host
    arrays of its chain) it was given."""

    def __init__(self, name):
        self.name, self.calls = name, []

    def __call__(self, dtype, *args):
        self.calls.append(args)
        if self.name == "bottom_step":
            (do_predict, cov, mu, vel, dt, q_a, n, models_a, z_a, r_a, dir_a, org_a, thr_a, m2_a, acc_a, nu_a,
             cov_out, mu_out, nb, _) = args
            host = lambda ctype, addr: list((ctype * max(1, n)).from_address(addr))[:n]
            models = tuple(MODEL_NAME[i] for i in host(ctypes.c_int, models_a))
            ms = [bf.FUSED_MODELS[model] for model in models]
            ptrs = lambda addr: host(ctypes.c_void_p, addr)
            z_ts = [_lanes(p, dtype, 3 if model == "normal" else 1, nb) for p, model in zip(ptrs(z_a), models)]
            r_ts = [_lanes(p, dtype, m, m, nb) for p, m in zip(ptrs(r_a), ms)]
            dir_ts = [_lanes(p, dtype, 3, nb) for p in ptrs(dir_a)]
            org_ts = [_lanes(p, dtype, 3, nb) for p in ptrs(org_a)]
            q9 = list((ctypes.c_double * 9).from_address(q_a)) if do_predict else []
            ref = bf.bottom_step_lanes_plain(models, bool(do_predict), _lanes(cov, dtype, 3, 3, nb),
                                             _lanes(mu, dtype, 4, nb), _lanes(vel, dtype, 3, nb), dt, q9, z_ts,
                                             r_ts, dir_ts, org_ts, host(ctypes.c_double, thr_a))
            outs = [(_lanes(cov_out, dtype, 3, 3, nb), ref[0]), (_lanes(mu_out, dtype, 4, nb), ref[1])]
            for p2, pa, pn, m, info in zip(ptrs(m2_a), ptrs(acc_a), ptrs(nu_a), ms, ref[2]):
                outs += [(_lanes(p2, dtype, 1, nb), info[0]), (_lanes(pa, dtype, 1, nb), info[1]),
                         (_lanes(pn, dtype, m, nb), info[2])]
        else:
            cov, mu, ref_, mk, z, r, scal, k, cov_out, mu_out, m2, nu, nb, _ = args
            ref = ifu.indirect_markers_lanes_plain(
                _lanes(cov, dtype, 6, 6, nb), _lanes(mu, dtype, 7, nb), _lanes(ref_, dtype, 7, nb),
                _lanes(mk, dtype, 7, nb), _lanes(z, dtype, k, 3, nb), _lanes(r, dtype, k, 2, 2, nb),
                _lanes(scal, dtype, 43 + 3 * k))
            outs = zip((_lanes(cov_out, dtype, 6, 6, nb), _lanes(mu_out, dtype, 7, nb), _lanes(m2, dtype, k, nb),
                        _lanes(nu, dtype, k, 2, nb)), ref)
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
def test_k7_wrapper_hands_the_kernel_its_operands_and_no_scratch(monkeypatch, case):
    args = bottom_operands(9, torch.float64, "cpu", seed=1)[case]
    fake, at_launch = _hand_over(monkeypatch, "bottom_step")
    out = bf.bottom_step_lanes_cuda(*args)
    (call,) = fake.calls
    assert len(call) == 20  # the scalars, the chain's host arrays, 2 outputs, bank, stream: no scratch
    assert call[1:4] == tuple(t.data_ptr() for t in args[2:5])  # cov, mu, vel in place
    host = lambda ctype, addr: list((ctype * max(1, call[6])).from_address(addr))[:call[6]]
    assert host(ctypes.c_void_p, call[8]) == [t.data_ptr() for t in args[7]]  # each z in place
    outs = flat(out)
    assert [call[16], call[17]] + [p for a in (13, 14, 15) for p in host(ctypes.c_void_p, call[a])] == [
        outs[0].data_ptr(), outs[1].data_ptr(), *(x.data_ptr() for x in outs[2::3]),
        *(x.data_ptr() for x in outs[3::3]), *(x.data_ptr() for x in outs[4::3])]
    assert sorted(at_launch) == sorted(x.data_ptr() for x in outs)  # only the outputs
    for o, p in zip(outs, flat(bf.bottom_step_lanes_plain(*args))):
        torch.testing.assert_close(o, p, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("k,per_instance", [(1, False), (1, True), (4, False), (4, True)])
def test_k10_wrapper_hands_the_kernel_its_operands_and_no_scratch(monkeypatch, k, per_instance):
    args = indirect_operands(5, torch.float64, "cpu", k, per_instance, seed=2)
    fake, at_launch = _hand_over(monkeypatch, "indirect_markers")
    out = ifu.indirect_markers_lanes_cuda(*args)
    (call,) = fake.calls
    assert len(call) == 14  # 7 operands, the corner count, 4 outputs, bank, stream: no scratch
    assert call[:7] == tuple(t.data_ptr() for t in args) and call[7] == k and call[12] == 5
    assert call[8:12] == tuple(t.data_ptr() for t in out) == tuple(at_launch)  # only the outputs
    ref = ifu.indirect_markers_lanes_plain(*args)
    for o, p in zip(out, ref):
        torch.testing.assert_close(o, p, rtol=0, atol=0, equal_nan=True)


class FakeLibrary:
    """Records which C entry point a launch calls, with what, and returns
    ``rc``."""

    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or self.rc


@pytest.mark.parametrize("name", ["bottom_step", "indirect_markers"])
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


def test_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch):
    """No corners, an update chain past MAX_STEP_UPDATES, or an operand of
    the wrong shape raise before any launch."""
    fake7, _ = _hand_over(monkeypatch, "bottom_step")
    args = bottom_operands(3, torch.float64, "cpu", seed=3)["predict+range+normal"]
    with pytest.raises(ValueError, match="MAX_STEP_UPDATES"):
        bf.bottom_step_lanes_cuda(("range",) * 9, *args[1:])
    with pytest.raises(ValueError, match="expected"):
        bf.bottom_step_lanes_cuda(args[0], args[1], args[2][..., :2], *args[3:])
    fake10, _ = _hand_over(monkeypatch, "indirect_markers")
    ops = indirect_operands(3, torch.float64, "cpu", 1, False, seed=3)
    with pytest.raises(ValueError, match="at least one corner"):
        ifu.indirect_markers_lanes_cuda(*ops[:4], ops[4][:0], ops[5][:0], ops[6][:43])
    with pytest.raises(ValueError, match="expected"):
        ifu.indirect_markers_lanes_cuda(ops[0][..., :2], *ops[1:])
    assert not fake7.calls and not fake10.calls

"""K11, the PoseUKF visual-marker update with the 59-DOF augmentation of
``csrc/pose_markers.cu``, and K4, the generic-h update tail of
``csrc/pose_update_tail.cu``, both one warp per instance
(``csrc/warp_markers.cuh``, ``csrc/warp_update.cuh``), against their plain
PyTorch versions.

The tests marked ``cuda`` run the kernels on the card and skip without one (a
CUDA kernel has no CPU mode): float32 and float64 at banks of 1, 7, 8, 9, 300,
600 and 2200 (one warp a block up to 300, then wider blocks), with NaN in the
covariance half no version reads. K11 with 1 and 4 corners, shared and
per-instance marker data, and pad lanes that leave the bank's outputs
unchanged and stay finite; K4 for m = 1, 2, 3 and 6 with χ² gates that accept
most instances and reject every 7th, instance 5's S NaN (its prior kept bit
for bit), and a threshold < 0 that accepts any. Limits are the other card
tests': float64 1e-9, float32 2e-3 of the normalized error, and for K11
chip_smoke.py's MARKER_LIMITS (2.1e-3 in float32: the plain version's own
float32 spread over four chained corners). ``tests/test_torch_cuda_kernels.py``
holds both kernels to the bits of their first (one-thread) design.

The other tests run on the CPU: each wrapper hands its kernel the operands'
own memory and allocates only the outputs (no scratch), and a stand-in for
the kernel that computes the plain version through those pointers gives its
result. This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_warp_markers.py
"""

import numpy as np
import pytest
import torch
from test_torch_warp_predict import _lanes, cov_error, rel

from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
from slam_uwv_kalman_filters_tpu_torch.models import pose_marker_fused as pmf
from slam_uwv_kalman_filters_tpu_torch.models import pose_ukf as pukf
from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf
from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
from slam_uwv_kalman_filters_tpu_torch.ops import dynamics as dyn
from slam_uwv_kalman_filters_tpu_torch.ops import manifolds as mf
from slam_uwv_kalman_filters_tpu_torch.parallel import bank
from slam_uwv_kalman_filters_tpu_torch.utils.config import CameraConfiguration, default_pose_ukf_config

LIMIT = {torch.float32: 2e-3, torch.float64: 1e-9}
MARKER_LIMIT = {torch.float32: 2.1e-3, torch.float64: 1e-9}
BANKS = [1, 7, 8, 9, 300, 600, 2200]
N, S = 53, 54
CORNERS = ((0.15, 0.15, 0.0), (-0.15, 0.15, 0.0), (-0.15, -0.15, 0.0), (0.15, -0.15, 0.0))
CAM_Q = (0.5, -0.5, 0.5, -0.5)  # the optical axis along body +x


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def nan_upper(cov_t):
    """NaN at [c, r < c], the half of a lanes covariance no version reads."""
    upper = torch.tril(torch.ones(N, N, dtype=torch.bool, device=cov_t.device), -1)[..., None]
    return torch.where(upper, float("nan"), cov_t).contiguous()


def mission_states(nb, rng):
    """nb PoseUKF states about the mission's start (float64, CPU): positions
    moved by 0.5 m, orientations by ~0.05 rad, velocities by 0.2 m/s,
    correlated covariances at half the initial per-field scales."""
    f64 = torch.float64
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=f64)
    state, _ = pukf.init_from_pose(
        torch.zeros(3, dtype=f64), torch.eye(3, dtype=f64) * 0.01, torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=f64),
        torch.eye(3, dtype=f64) * 1e-4, default_pose_ukf_config(), dyn.default_uwv_parameters(device="cpu"),
        device="cpu",
    )
    g = rng.normal(size=(nb, N, N))
    c = g @ np.swapaxes(g, 1, 2) / N + np.eye(N)
    sd = np.sqrt(np.diagonal(c, axis1=1, axis2=2))
    scale = 0.5 * np.sqrt(np.diag(state.cov.numpy()))
    bs = bank.replicate(state, nb)
    return bs._replace(
        mu=bs.mu._replace(position=t(0.5 * rng.normal(size=(nb, 3))),
                          orientation=mf.so3_boxplus(bs.mu.orientation, t(0.05 * rng.normal(size=(nb, 3)))),
                          velocity=t(0.2 * rng.normal(size=(nb, 3)))),
        cov=t(c / (sd[:, :, None] * sd[:, None, :]) * scale[None, :, None] * scale[None, None, :]))


def marker_operands(nb, dtype, device, k, per_instance, seed=0, lanes=None):
    """K11's operands on :func:`mission_states`: k corners of a marker 6 m
    ahead, seen from each instance's own pose with 1 px of noise, pixel
    covariance 4·I, a 1e-3·I marker-pose prior, the camera 0.1 m off the
    IMU; pixels and the marker pose shared or per instance. ``lanes`` > nb
    pads in the JAX package's convention (identity covariances, copies of
    instance 0; the pad corners come from ``pose_marker_fused``)."""
    f64 = torch.float64
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=f64)
    bs = mission_states(nb, rng)
    corners = t(CORNERS[:k])
    mpos, mrot = t([6.0, 0.0, 0.0]), t(CAM_Q)
    if per_instance:
        mpos = mpos + t(0.05 * rng.normal(size=(nb, 3)))
        mrot = mf.so3_boxplus(mrot.expand(nb, 4), t(0.02 * rng.normal(size=(nb, 3))))
    cam, cam_p, cam_q = CameraConfiguration(), t([0.1, -0.05, 0.02]), t(CAM_Q)
    qi, pi = mf.affine_inv(*mf.affine_mul(bs.mu.orientation, bs.mu.position, cam_q, cam_p))
    f_cam = mf.affine_apply(qi[:, None], pi[:, None], mf.affine_apply(mrot[..., None, :], mpos[..., None, :], corners))
    px = torch.stack([cam.fx * f_cam[..., 0] / f_cam[..., 2] + cam.cx, cam.fy * f_cam[..., 1] / f_cam[..., 2] + cam.cy],
                     -1) + t(rng.normal(size=(nb, k, 2)))
    ls = pf.to_lanes(bs)
    if lanes is not None:
        pad = lanes - nb
        ls = ls._replace(cov_t=torch.cat([ls.cov_t, torch.eye(N, dtype=f64)[..., None].expand(N, N, pad)], -1),
                         mu_t=torch.cat([ls.mu_t, ls.mu_t[:, :1].expand(S, pad)], -1))
    ls = ls._replace(cov_t=nan_upper(ls.cov_t.to(device=device, dtype=dtype)),
                     mu_t=ls.mu_t.to(device=device, dtype=dtype).contiguous())
    dev = lambda x: x.to(device)
    return pmf.marker_operands(ls, dev(px if per_instance else px[0]), dev(4.0 * torch.eye(2, dtype=f64)),
                               dev(corners), dev(mpos), dev(mrot), dev(1e-3 * torch.eye(6, dtype=f64)), cam,
                               dev(cam_p), dev(cam_q), nb=nb)[1]


def tail_operands(nb, dtype, device, m, thr, seed=0):
    """K4's operands on :func:`mission_states`: the covariance's own sigma
    deltas (zero, +columns, −columns of its Cholesky factor), dz = H·δ +
    noise, R = 0.05·I, ν with every 7th instance far out (so a χ² gate
    rejects it) and, where the threshold is ≥ 0, instance 5's S NaN."""
    rng = np.random.default_rng(seed)
    ls = pf.to_lanes(mission_states(nb, rng))
    lc = np.linalg.cholesky(np.transpose(ls.cov_t.numpy(), (2, 1, 0)))  # (nb, k, j)
    cols = np.transpose(lc, (2, 1, 0))  # (j, k, nb): column j at row k
    deltas = np.concatenate([np.zeros((1, N, nb)), cols, -cols])
    dz = np.einsum("in,pnb->pib", 0.3 * rng.normal(size=(m, N)), deltas) + 0.01 * rng.normal(size=(2 * N + 1, m, nb))
    nu = 0.3 * rng.normal(size=(m, nb))
    nu[:, ::7] += 10.0
    r = np.repeat((0.05 * np.eye(m))[..., None], nb, -1)
    if thr >= 0 and nb > 5:
        r[0, 0, 5] = np.nan
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)
    return (t(deltas), t(dz), t(nu), t(r), t(ls.mu_t.numpy()), nan_upper(t(ls.cov_t.numpy())), thr)


def valid(x):
    return x[torch.triu(torch.ones(N, N, dtype=torch.bool, device=x.device))]


@pytest.mark.cuda
@pytest.mark.parametrize("k,per_instance", [(1, False), (1, True), (4, False), (4, True)])
@pytest.mark.parametrize("nb", BANKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k11_matches_plain(device, dtype, nb, k, per_instance):
    args = marker_operands(nb, dtype, device, k, per_instance, seed=nb)
    k11 = cuda_lib.KERNELS["pose_markers"]
    before = k11.launches
    ko = pmf.pose_markers_lanes_cuda(*args)
    torch.cuda.synchronize()
    assert k11.launches == before + 1
    po = pmf.pose_markers_lanes_plain(*args)
    assert bool(torch.isfinite(valid(ko[0])).all()) and all(bool(torch.isfinite(x).all()) for x in ko[1:])
    assert cov_error(ko[0], po[0], args[0]) <= MARKER_LIMIT[dtype]  # normalized by the prior
    assert max(rel(ko[i], po[i]) for i in (1, 2, 3)) <= MARKER_LIMIT[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [7, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k11_pad_lanes_leave_the_bank_alone(device, dtype, nb):
    """28 pad lanes (identity covariance, pad corners: bearing (0, 0, 1),
    R = I, an identity marker pose) leave the bank's outputs bit-identical
    and stay finite."""
    plain_bank = pmf.pose_markers_lanes_cuda(*marker_operands(nb, dtype, device, 4, True, seed=nb))
    padded = pmf.pose_markers_lanes_cuda(*marker_operands(nb, dtype, device, 4, True, seed=nb, lanes=nb + 28))
    torch.cuda.synchronize()
    assert torch.equal(valid(plain_bank[0]), valid(padded[0][..., :nb]))
    assert all(torch.equal(a, b[..., :nb]) for a, b in zip(plain_bank[1:], padded[1:]))
    assert bool(torch.isfinite(valid(padded[0][..., nb:])).all())
    assert all(bool(torch.isfinite(b[..., nb:]).all()) for b in padded[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [-1.0, 5.991])
@pytest.mark.parametrize("m", [1, 2, 3, 6])
@pytest.mark.parametrize("nb", BANKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k4_matches_plain(device, dtype, nb, m, thr):
    args = tail_operands(nb, dtype, device, m, thr, seed=nb)
    k4 = cuda_lib.KERNELS["pose_update_tail"]
    before = k4.launches
    ko = puf.update_tail_cuda(*args)
    torch.cuda.synchronize()
    assert k4.launches == before + 1
    po = puf.update_tail_plain(*args)
    assert cov_error(ko[0], po[0], args[5]) <= LIMIT[dtype]
    assert rel(ko[1], po[1]) <= LIMIT[dtype]
    assert torch.equal(torch.isnan(ko[2]), torch.isnan(po[2]))
    assert rel(torch.nan_to_num(ko[2]), torch.nan_to_num(po[2])) <= LIMIT[dtype]
    assert torch.equal(ko[3], po[3])
    if thr < 0:
        assert bool((ko[3] == 1.0).all())  # a threshold < 0 accepts any
    elif nb > 7:
        assert ko[3][0, 7] == 0.0 and ko[3][0, 1] == 1.0  # every 7th far out, the rest inside
        assert ko[3][0, 5] == 0.0  # the NaN S keeps its prior, bit for bit
        assert torch.equal(valid(ko[0][..., 5]), valid(args[5][..., 5]))
        assert torch.equal(ko[1][:, 5], args[4][:, 5])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_warps_per_block(device, dtype):
    """One warp a block until the bank spreads over 2·264 blocks, then the
    widest block that keeps 12 warps resident (or the most): K11's 17.3 KB
    tile keeps 12 at 4 warps a block in float32 (34.5 KB in float64: 6 at
    2), K4's 7.9 KB at m = 6 more than 12 at 8 (15.8 KB: 12 at 4)."""
    k11, k4 = cuda_lib.KERNELS["pose_markers"], cuda_lib.KERNELS["pose_update_tail"]
    banks = (1, 300, 600, 1100, 2200, 131072)
    wide = 4 if dtype == torch.float32 else 2
    assert [k11.warps_per_block(dtype, nb) for nb in banks] == [1, 1, 2, wide, wide, wide]
    assert k11.resident_warps(dtype, 131072) >= (12 if dtype == torch.float32 else 6)
    wide = 8 if dtype == torch.float32 else 4
    assert [k4.warps_per_block(dtype, 6, nb) for nb in banks] == [1, 1, 2, 4, wide, wide]
    assert k4.resident_warps(dtype, 6, 131072) >= 12


# ---------------------------------------------------------------------------
# the wrappers' operands, on the CPU, against a stand-in for the kernel
# ---------------------------------------------------------------------------


class StandIn:
    """Records each launch and computes the kernel's function, as its C
    interface defines it, through the pointers it was given."""

    def __init__(self, name):
        self.name, self.calls = name, []

    def __call__(self, dtype, *args):
        self.calls.append(args)
        if self.name == "pose_markers":
            cov, mu, mk, z, r, scal, k, cov_out, mu_out, m2, nu, nb, _ = args
            ref = pmf.pose_markers_lanes_plain(
                _lanes(cov, dtype, N, N, nb), _lanes(mu, dtype, S, nb), _lanes(mk, dtype, 7, nb),
                _lanes(z, dtype, k, 3, nb), _lanes(r, dtype, k, 2, 2, nb), _lanes(scal, dtype, 43 + 3 * k))
            outs = (_lanes(cov_out, dtype, N, N, nb), _lanes(mu_out, dtype, S, nb), _lanes(m2, dtype, k, nb),
                    _lanes(nu, dtype, k, 2, nb))
        else:
            m, d, dz, nu, r, mu, cov, thr, cov_out, mu_out, m2, acc, nb, _ = args
            ref = puf.update_tail_plain(
                _lanes(d, dtype, 2 * N + 1, N, nb), _lanes(dz, dtype, 2 * N + 1, m, nb), _lanes(nu, dtype, m, nb),
                _lanes(r, dtype, m, m, nb), _lanes(mu, dtype, S, nb), _lanes(cov, dtype, N, N, nb), thr)
            outs = (_lanes(cov_out, dtype, N, N, nb), _lanes(mu_out, dtype, S, nb), _lanes(m2, dtype, 1, nb),
                    _lanes(acc, dtype, 1, nb))
        for o, x in zip(outs, ref):
            o.copy_(x)


def _hand_over(monkeypatch, name):
    """Stand in for kernel ``name`` and record what the wrapper allocates
    before its launch."""
    fake, allocated, at_launch = StandIn(name), [], []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: allocated.append(empty(*a, **kw)) or allocated[-1])
    monkeypatch.setattr(cuda_lib.KERNELS[name], "launch",
                        lambda *a: at_launch.extend(t.data_ptr() for t in allocated) or fake(*a))
    monkeypatch.setattr(cuda_lib, "stream_ptr", lambda device: None)
    return fake, at_launch


@pytest.mark.parametrize("k,per_instance", [(1, False), (4, True)])
def test_k11_wrapper_hands_the_kernel_its_operands_and_no_scratch(monkeypatch, k, per_instance):
    args = marker_operands(5, torch.float64, "cpu", k, per_instance, seed=1)
    fake, at_launch = _hand_over(monkeypatch, "pose_markers")
    out = pmf.pose_markers_lanes_cuda(*args)
    (call,) = fake.calls
    assert len(call) == 13  # 6 operands, the corner count, 4 outputs, bank, stream: no scratch
    assert call[:6] == tuple(t.data_ptr() for t in args)  # every operand in place
    assert call[6] == k and call[11] == 5
    assert call[7:11] == tuple(t.data_ptr() for t in out) == tuple(at_launch)  # only the outputs
    ref = pmf.pose_markers_lanes_plain(*args)
    for o, p in zip(out, ref):
        torch.testing.assert_close(o, p, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("m,thr", [(1, -1.0), (6, 5.991)])
def test_k4_wrapper_hands_the_kernel_its_operands_and_no_scratch(monkeypatch, m, thr):
    args = tail_operands(9, torch.float64, "cpu", m, thr, seed=2)
    fake, at_launch = _hand_over(monkeypatch, "pose_update_tail")
    out = puf.update_tail_cuda(*args)
    (call,) = fake.calls
    assert len(call) == 14  # m, 6 operands, the threshold, 4 outputs, bank, stream: no scratch
    assert call[0] == m and call[1:7] == tuple(t.data_ptr() for t in args[:6]) and call[7] == thr
    assert call[8:12] == tuple(t.data_ptr() for t in out) == tuple(at_launch)  # only the outputs
    assert call[12] == 9
    ref = puf.update_tail_plain(*args)
    for o, p in zip(out, ref):
        torch.testing.assert_close(o, p, rtol=0, atol=0, equal_nan=True)


def test_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch):
    """No corners, a measurement dimension past MAX_TAIL_M, or an operand of
    the wrong shape raise before any launch."""
    fake11, _ = _hand_over(monkeypatch, "pose_markers")
    args = marker_operands(3, torch.float64, "cpu", 1, False, seed=3)
    with pytest.raises(ValueError, match="at least one corner"):
        pmf.pose_markers_lanes_cuda(args[0], args[1], args[2], args[3][:0], args[4][:0], args[5][:43])
    with pytest.raises(ValueError):
        pmf.pose_markers_lanes_cuda(args[0][..., :2], *args[1:])
    fake4, _ = _hand_over(monkeypatch, "pose_update_tail")
    tail = tail_operands(3, torch.float64, "cpu", 6, -1.0, seed=3)
    with pytest.raises(ValueError, match="MAX_TAIL_M"):
        puf._pose_update_lanes(tail[0], torch.cat([tail[1], tail[1][:, :1]], 1), *tail[2:])
    with pytest.raises(ValueError, match="expected"):
        puf.update_tail_cuda(tail[0][:, :, :2], *tail[1:])
    assert not fake11.calls and not fake4.calls

"""K2, the fused PoseUKF predict of ``csrc/pose_predict.cu`` in its shared and
its full (banked) mode, and K5, the whole step of ``csrc/pose_step.cu``, both
one warp per instance (``csrc/warp_predict.cuh``), against their plain
PyTorch versions.

The tests marked ``cuda`` run the kernels on the card and skip without one (a
CUDA kernel has no CPU mode): float32 and float64 at banks of 1, 7, 8 and 9,
300, 600 and 2200 (one warp a block up to 300, then 2 to 8 in float32), on
mission-like states with NaN in the covariance half no version reads, K5 on
the six-model chain with the χ²-95 gates. Limits are the other card tests':
float64 1e-9, float32 2e-3 of the normalized error. K5 is also held bit for
bit to K2 followed by one K3 launch per update at banks that give 1, 2, 4
and 8 warps a block. ``tests/test_torch_cuda_kernels.py`` holds both kernels
to the bits of their first (one-thread) design.

The other tests run on the CPU: each wrapper hands its kernel the operands'
own memory and allocates only the outputs (no scratch), and a stand-in for
the kernel that computes the plain version through those pointers gives its
result. This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_warp_predict.py
"""

import ctypes

import numpy as np
import pytest
import torch
from test_torch_warp_kernels import _strided

from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
from slam_uwv_kalman_filters_tpu_torch.models import pose_ukf as pukf
from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf
from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
from slam_uwv_kalman_filters_tpu_torch.ops import dynamics as dyn
from slam_uwv_kalman_filters_tpu_torch.parallel import bank
from slam_uwv_kalman_filters_tpu_torch.utils.config import default_pose_ukf_config

LIMIT = {torch.float32: 2e-3, torch.float64: 1e-9}
BANKS = [1, 7, 8, 9, 300, 600, 2200]
# banks and the warps a block they give in float32 (the widest block that
# keeps the most warps resident, spread over at least 264 blocks)
WARPS_F32 = {300: 1, 600: 2, 1100: 4, 2200: 8}
N, S = 53, 54
VAR = {"velocity": 1e-3, "z_position": 0.01, "xy_position": 0.5, "acceleration": 4e-5, "pressure": 2500.0,
       "water_velocity": 1e-3}
AUX = {"pressure": (101325.0, 0.1, 0.2, -0.3), "water_velocity": (0.3,)}
GATE = {"xy_position": 5.991, "water_velocity": 5.991}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def predict_operands(nb, dtype, device, full, seed=0):
    """K2's operands on ``nb`` mission states: moved means and rotation
    rates, correlated covariances scaled like the initial one (NaN at [c, r <
    c], the half no version reads); in full mode a banked draw that moves
    every per-instance operand (process noise, current scale, time
    constants, rest points, projection anchor)."""
    f64 = torch.float64
    state, params = pukf.init_from_pose(
        torch.zeros(3, dtype=f64), torch.eye(3, dtype=f64) * 0.01,
        torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=f64), torch.eye(3, dtype=f64) * 1e-4,
        default_pose_ukf_config(), dyn.default_uwv_parameters(device="cpu"), device="cpu",
    )
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(nb, N, N))
    c = g @ np.swapaxes(g, 1, 2) / N + np.eye(N)
    sd = np.sqrt(np.diagonal(c, axis1=1, axis2=2))
    scale = np.sqrt(np.diag(state.cov.numpy()))
    cov = c / (sd[:, :, None] * sd[:, None, :]) * scale[None, :, None] * scale[None, None, :]
    mu = np.tile(pf._pack_storage(bank.tree_map(lambda a: a[None], state.mu)).numpy(), (nb, 1))
    mu[:, 0:3] += rng.normal(size=(nb, 3))
    mu[:, 7:10] = 0.5 * rng.normal(size=(nb, 3))
    yaw = 0.3 * rng.normal(size=nb)
    mu[:, 3], mu[:, 6] = np.cos(yaw / 2), np.sin(yaw / 2)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)
    cov_t = t(np.transpose(cov, (2, 1, 0)))
    unread = torch.tril(torch.ones(N, N, dtype=torch.bool, device=device), -1)[..., None]
    cov_t = torch.where(unread, float("nan"), cov_t).to(dtype).contiguous()
    rr_t = t(0.01 * rng.normal(size=(3, nb)))
    p = bank.tree_map(lambda a: a.to(device=device, dtype=dtype), params)
    if not full:
        return (cov_t, t(mu.T), rr_t, *pf._predict_operands_shared(p, 0.01, dtype))
    draw = lambda *s: t(1.0 + 0.2 * np.clip(rng.normal(size=(nb, *s)), -3, 3))
    bp = bank.tree_map(lambda x: x.expand(nb, *x.shape), p)
    bp = bp._replace(
        process_noise=bp.process_noise * draw()[:, None, None],
        water_velocity_scale=bp.water_velocity_scale * draw(),
        gyro_bias_tau=bp.gyro_bias_tau * draw(), quad_damping_tau=bp.quad_damping_tau * draw(),
        inertia_offset=bp.inertia_offset * draw(3, 3),
        projection=bp.projection._replace(lat0=bp.projection.lat0 * draw()),
    )
    bo = pf.banked_predict_operands(bp, 0.01, dtype)
    return (cov_t, t(mu.T), rr_t, bo.coeff, bo.offs, bo.q0m_t, bo.scal, bo.aux_t)


def step_operands(nb, dtype, device, models=puf.STEP_MODELS, seed=0):
    """K5's operands: K2's shared-mode ones, then per update z near the
    prediction with instance 0 pushed out of the χ²-95 gate of xy_position
    and water_velocity, R = var·I."""
    ops = predict_operands(nb, dtype, device, False, seed)
    rng = np.random.default_rng(seed + 1)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)
    z_ts, r_ts, s6 = [], [], []
    for model in models:
        m = puf.FUSED_MODELS[model]
        z = rng.normal(size=(m, nb))
        z = z * 50.0 + 101325.0 if model == "pressure" else z
        if model == "acceleration":
            z[2] += 9.81
        if model in GATE:
            z[:, 0] += 30.0
        z_ts.append(t(z))
        r_ts.append((torch.eye(m, dtype=dtype, device=device) * VAR[model])[..., None].expand(m, m, nb).contiguous())
        s6.append(puf._scal_block(GATE.get(model), AUX.get(model, ()), dtype, device).T)
    return (tuple(models), *ops, z_ts, r_ts, torch.cat(s6).contiguous())


def cov_error(out_t, ref_t, scale_t):
    valid = torch.triu(torch.ones(N, N, dtype=torch.bool, device=out_t.device))
    d = torch.diagonal(scale_t, dim1=0, dim2=1).T.abs()
    return ((out_t - ref_t).abs() / torch.sqrt(d[:, None] * d[None, :]))[valid].max().item()


def rel(a, b):
    return ((a - b).abs() / (1 + b.abs())).max().item()


def bits(x):
    return x.contiguous().view(torch.int32 if x.dtype == torch.float32 else torch.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", BANKS)
@pytest.mark.parametrize("mode", ["shared", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_matches_plain(device, dtype, mode, nb):
    args = predict_operands(nb, dtype, device, mode == "full", seed=nb)
    k2 = cuda_lib.KERNELS["pose_predict_full" if mode == "full" else "pose_predict"]
    before = k2.launches
    cov_k, mu_k = pf.predict_lanes_cuda(*args)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    cov_p, mu_p = pf.predict_lanes_plain(*args)
    valid = torch.triu(torch.ones(N, N, dtype=torch.bool, device=device))
    assert bool(torch.isfinite(cov_k[valid]).all()) and bool(torch.isfinite(mu_k).all())
    assert cov_error(cov_k, cov_p, cov_p) <= LIMIT[dtype]
    assert rel(mu_k, mu_p) <= LIMIT[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("nb", BANKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k5_matches_plain(device, dtype, nb):
    args = step_operands(nb, dtype, device, seed=nb)
    k5 = cuda_lib.KERNELS["pose_step"]
    before = k5.launches
    ko = puf.pose_step_lanes_cuda(*args)
    torch.cuda.synchronize()
    assert k5.launches == before + 1
    po = puf.pose_step_lanes_plain(*args)
    prior = pf.predict_lanes_plain(*args[1:8])[0]  # the updates' prior normalizes, as for K3
    assert cov_error(ko[0], po[0], prior) <= LIMIT[dtype]
    assert rel(ko[1], po[1]) <= LIMIT[dtype]
    for (km2, kacc, knu), (pm2, pacc, pnu) in zip(ko[2], po[2]):
        assert torch.equal(kacc, pacc)
        assert max(rel(km2, pm2), rel(knu, pnu)) <= LIMIT[dtype]
    gated = [k for k, model in enumerate(args[0]) if model in GATE]
    assert all(ko[2][k][1][0, 0] == 0.0 for k in gated)  # instance 0 rejected


@pytest.mark.cuda
@pytest.mark.parametrize("nb", sorted(WARPS_F32))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k5_bit_identical_to_k2_k3_chain(device, dtype, nb):
    """K5 runs K2's and K3's block bodies in one launch, so it equals K2
    followed by one K3 launch per update bit for bit, whatever the warps a
    block of each launch."""
    if dtype == torch.float32:
        assert cuda_lib.KERNELS["pose_step"].warps_per_block(dtype, nb) == WARPS_F32[nb]
    models, cov_t, mu_t, rr_t, coeff, offs, q0m, scal, z_ts, r_ts, scal6 = step_operands(nb, dtype, device, seed=nb)
    ko = puf.pose_step_lanes_cuda(models, cov_t, mu_t, rr_t, coeff, offs, q0m, scal, z_ts, r_ts, scal6)
    cov, mu = pf.predict_lanes_cuda(cov_t, mu_t, rr_t, coeff, offs, q0m, scal)
    valid = torch.triu(torch.ones(N, N, dtype=torch.bool, device=device))
    for k, model in enumerate(models):
        cov, mu, m2, acc, nu = puf.update_model_lanes_cuda(model, z_ts[k], r_ts[k], mu, cov, scal6[k][:, None].contiguous())
        for x, y in zip(ko[2][k], (m2, acc, nu)):
            assert torch.equal(bits(x), bits(y))
    assert torch.equal(bits(ko[0][valid]), bits(cov[valid]))
    assert torch.equal(bits(ko[1]), bits(mu))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_warps_per_block(device, dtype):
    """One warp a block until the bank spreads over 2·264 blocks, then the
    widest block that keeps the most warps resident: K2's and K5's tiles
    (26.5 KB in float32, 53 KB in float64) let 8 warps an SM in float32 and
    4 in float64."""
    widest = 8 if dtype == torch.float32 else 4
    for name in ("pose_predict", "pose_predict_full", "pose_step"):
        k = cuda_lib.KERNELS[name]
        got = [k.warps_per_block(dtype, nb) for nb in (1, 300, 600, 1100, 2200, 131072)]
        assert got == [1, 1, 2, min(4, widest), widest, widest], (name, got)


# ---------------------------------------------------------------------------
# the wrappers' operands, on the CPU, against a stand-in for the kernel
# ---------------------------------------------------------------------------


def _lanes(ptr, dtype, *shape):
    if ptr is None:
        return None
    return _strided(ptr, dtype, shape, tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape))))


class StandIn:
    """Records each launch and computes the kernel's function, as its C
    interface defines it, through the pointers it was given."""

    def __init__(self, name):
        self.name, self.calls, self.chains = name, [], []

    def __call__(self, dtype, *args):
        self.calls.append(args)
        if self.name == "pose_step":
            cov, mu, rr, coeff, offs, q0m, scal, n_upd, models_a, z_a, r_a, scal6, m2_a, acc_a, nu_a, cov_out, mu_out, nb, _ = args
            read = lambda addr, ctype: list((ctype * n_upd).from_address(addr))
            models = [list(puf.FUSED_MODELS)[i] for i in read(models_a, ctypes.c_int)]
            ms = [puf.FUSED_MODELS[m] for m in models]
            ptrs = {key: read(addr, ctypes.c_void_p) for key, addr in
                    (("z", z_a), ("r", r_a), ("m2", m2_a), ("acc", acc_a), ("nu", nu_a))}
            self.chains.append(dict(ptrs, models=models))  # the host arrays live only during the launch
            ref = puf.pose_step_lanes_plain(
                models, _lanes(cov, dtype, N, N, nb), _lanes(mu, dtype, S, nb), _lanes(rr, dtype, 3, nb),
                _lanes(coeff, dtype, S, 1), _lanes(offs, dtype, S, 1), _lanes(q0m, dtype, N, N, 1),
                _lanes(scal, dtype, 14, 1), [_lanes(p, dtype, m, nb) for p, m in zip(ptrs["z"], ms)],
                [_lanes(p, dtype, m, m, nb) for p, m in zip(ptrs["r"], ms)], _lanes(scal6, dtype, n_upd, 6))
            _lanes(cov_out, dtype, N, N, nb).copy_(ref[0])
            _lanes(mu_out, dtype, S, nb).copy_(ref[1])
            for k, (m2, acc, nu) in enumerate(ref[2]):
                _lanes(ptrs["m2"][k], dtype, 1, nb).copy_(m2)
                _lanes(ptrs["acc"][k], dtype, 1, nb).copy_(acc)
                _lanes(ptrs["nu"][k], dtype, ms[k], nb).copy_(nu)
            return
        full = self.name == "pose_predict_full"
        cov, mu, rr, coeff, offs, q0m, scal = args[:7]
        aux, (cov_out, mu_out, nb, _) = (args[7], args[8:]) if full else (None, args[7:])
        lanes = nb if full else 1
        ref = pf.predict_lanes_plain(
            _lanes(cov, dtype, N, N, nb), _lanes(mu, dtype, S, nb), _lanes(rr, dtype, 3, nb),
            _lanes(coeff, dtype, S, lanes), _lanes(offs, dtype, S, lanes), _lanes(q0m, dtype, N, N, lanes),
            _lanes(scal, dtype, 14, 1), _lanes(aux, dtype, 12, nb))
        _lanes(cov_out, dtype, N, N, nb).copy_(ref[0])
        _lanes(mu_out, dtype, S, nb).copy_(ref[1])


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


@pytest.mark.parametrize("mode", ["shared", "full"])
def test_k2_wrapper_hands_the_kernel_its_operands_and_no_scratch(monkeypatch, mode):
    args = predict_operands(5, torch.float64, "cpu", mode == "full", seed=1)
    fake, at_launch = _hand_over(monkeypatch, "pose_predict_full" if mode == "full" else "pose_predict")
    out = pf.predict_lanes_cuda(*args)
    (call,) = fake.calls
    n_ops = len(args)
    assert len(call) == n_ops + 4  # operands, cov_out, mu_out, bank, stream: no scratch
    assert call[:n_ops] == tuple(t.data_ptr() for t in args)  # every operand in place
    assert call[n_ops:n_ops + 2] == tuple(t.data_ptr() for t in out) == tuple(at_launch)  # only the outputs
    assert call[n_ops + 2] == 5
    ref = pf.predict_lanes_plain(*args)
    for o, p in zip(out, ref):
        torch.testing.assert_close(o, p, rtol=0, atol=0, equal_nan=True)


def test_k5_wrapper_hands_the_kernel_its_operands_and_no_scratch(monkeypatch):
    args = step_operands(5, torch.float64, "cpu", ("acceleration", "velocity", "water_velocity"), seed=1)
    fake, at_launch = _hand_over(monkeypatch, "pose_step")
    out = puf.pose_step_lanes_cuda(*args)
    (call,) = fake.calls
    assert len(call) == 19  # 7 operands, the chain (count, 5 host arrays, scal6), cov_out, mu_out, bank, stream
    assert call[:7] == tuple(t.data_ptr() for t in args[1:8])  # the state and the predict operands in place
    assert call[7] == 3 and call[11] == args[10].data_ptr()
    (chain,) = fake.chains
    assert chain["models"] == list(args[0])
    assert chain["z"] == [t.data_ptr() for t in args[8]] and chain["r"] == [t.data_ptr() for t in args[9]]
    assert [chain[key] for key in ("m2", "acc", "nu")] == [[info[i].data_ptr() for info in out[2]] for i in range(3)]
    outputs = [out[0], out[1], *(x for info in out[2] for x in info)]
    assert call[15:17] == (out[0].data_ptr(), out[1].data_ptr())
    assert sorted(at_launch) == sorted(t.data_ptr() for t in outputs)  # the outputs are all it allocates
    ref = puf.pose_step_lanes_plain(*args)
    for o, p in zip(outputs, [ref[0], ref[1], *(x for info in ref[2] for x in info)]):
        torch.testing.assert_close(o, p, rtol=0, atol=0, equal_nan=True)


def test_k5_wrapper_refuses_what_the_kernel_cannot_chain(monkeypatch):
    fake, _ = _hand_over(monkeypatch, "pose_step")
    args = step_operands(3, torch.float64, "cpu", ("velocity",), seed=2)
    with pytest.raises(ValueError, match="body_efforts"):
        puf.pose_step_lanes_cuda(("body_efforts",), *args[1:])
    with pytest.raises(ValueError, match="at most"):
        puf.pose_step_lanes_cuda(("velocity",) * (puf.MAX_STEP_UPDATES + 1), *args[1:])
    assert not fake.calls

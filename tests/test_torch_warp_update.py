"""K3, the in-kernel-model PoseUKF update of ``csrc/pose_update.cu`` (one
warp per instance, ``csrc/warp_update.cuh``), against its plain PyTorch
version.

The tests marked ``cuda`` run the kernel on the card and skip without one (a
CUDA kernel has no CPU mode): all seven models with shared and per-instance
aux values, float32 and float64, at banks of 1, 7, 8 and 9 (one warp a
block), 300, and 600 and 2200 (the bank spreads over 2 to 8 warps a block),
on mission-like states with NaN in the covariance half no version reads.
Limits are the other card tests': float64 1e-9, float32 2e-3 of the
normalized error. Under a gate, an instance whose S is NaN keeps its prior
bit for bit (mean and valid covariance half) and is rejected; a threshold
below 0 accepts a measurement however far off. ``tests/test_torch_cuda_kernels.py``
holds K3 to the bits of its first (one-thread) design.

The other tests run on the CPU: the wrapper hands the kernel the operands'
own memory and allocates only the five outputs (no scratch), and a stand-in
for the kernel that computes the plain version through those pointers gives
its result. This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_warp_update.py
"""

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
AUX = {"pressure": (101325.0, 0.1, 0.2, -0.3), "water_velocity": (0.3,), "body_efforts": (0.01, 0.02, -0.01)}
N = 53


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def operands(model, nb, dtype, device, banked, seed=0):
    """K3's operands for ``model`` on ``nb`` mission states: moved means,
    correlated covariances scaled like the initial one (NaN at [c, r < c],
    the half no version reads), z near the prediction, R = 0.5·I, the χ²-95
    gate for xy_position and water_velocity, aux shared or per instance."""
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
    m = puf.FUSED_MODELS[model]
    z = rng.normal(size=(m, nb))
    z = z * 50.0 + 101325.0 if model == "pressure" else z
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)
    cov_t = t(np.transpose(cov, (2, 1, 0)))
    unread = torch.tril(torch.ones(N, N, dtype=torch.bool, device=device), -1)[..., None]
    cov_t = torch.where(unread, float("nan"), cov_t).to(dtype).contiguous()
    aux = AUX.get(model, ())
    aux_t = None
    if banked:
        aux_t = t(0.01 * rng.normal(size=(5, nb)) + np.asarray(list(aux) + [0.0] * (5 - len(aux)))[:, None])
        aux = ()
    thr = 5.991 if model in ("xy_position", "water_velocity") else None
    r = (torch.eye(m, dtype=dtype, device=device) * 0.5)[..., None].expand(m, m, nb).contiguous()
    p = bank.tree_map(lambda a: a.to(device=device, dtype=dtype), params)
    return (model, t(z), r, t(mu.T), cov_t, puf._scal_block(thr, aux, dtype, device), aux_t,
            puf._efforts_model_scal(p, dtype) if model == "body_efforts" else None)


def errors(out, ref, cov_t):
    """Normalized errors of (cov_out, mu_out, m2, acc, nu): the valid half of
    the covariance over √(P_cc·P_rr) of the prior, the rest over 1 + |ref|."""
    valid = torch.triu(torch.ones(N, N, dtype=torch.bool, device=cov_t.device))
    d = torch.diagonal(cov_t, dim1=0, dim2=1).T.abs()
    errs = [((out[0] - ref[0]).abs() / torch.sqrt(d[:, None] * d[None, :]))[valid].max().item()]
    return errs + [((k - p).abs() / (1 + p.abs())).max().item() for k, p in zip(out[1:], ref[1:])]


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 7, 8, 9, 300, 600, 2200])
@pytest.mark.parametrize("banked", [False, True], ids=["shared", "banked"])
@pytest.mark.parametrize("model", list(puf.FUSED_MODELS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k3_matches_plain(device, dtype, model, banked, nb):
    args = operands(model, nb, dtype, device, banked, seed=nb)
    k3 = cuda_lib.KERNELS["pose_update_model"]
    before = k3.launches
    out = puf.update_model_lanes_cuda(*args)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    ref = puf.update_model_lanes_plain(*args)
    valid = torch.triu(torch.ones(N, N, dtype=torch.bool, device=device))
    assert all(bool(torch.isfinite(o[valid] if o.ndim == 3 else o).all()) for o in out)
    assert max(errors(out, ref, args[4])) <= LIMIT[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k3_nan_s_keeps_the_prior_and_a_negative_threshold_accepts(device, dtype):
    nb, bad, far = 40, 5, 9
    model, z, r, mu_t, cov_t, scal, aux_t, msc = operands("xy_position", nb, dtype, device, False, seed=3)
    r[0, 0, bad] = float("nan")  # S NaN for one instance
    z[:, far] += 1e3  # far outside the χ²-95 gate
    valid = torch.triu(torch.ones(N, N, dtype=torch.bool, device=device))
    gated = puf.update_model_lanes_cuda(model, z, r, mu_t, cov_t, scal, aux_t, msc)
    scal_any = scal.clone()
    scal_any[0] = -1.0
    open_ = puf.update_model_lanes_cuda(model, z, r, mu_t, cov_t, scal_any, aux_t, msc)
    torch.cuda.synchronize()
    assert torch.equal(gated[0][..., bad][valid], cov_t[..., bad][valid])
    assert torch.equal(gated[1][:, bad], mu_t[:, bad])
    assert gated[3][0, bad].item() == 0.0 and bool(torch.isnan(gated[2][0, bad]))
    assert gated[3][0, far].item() == 0.0 and open_[3][0, far].item() == 1.0
    assert torch.equal(gated[0][..., far][valid], cov_t[..., far][valid])
    assert not torch.equal(open_[0][..., far][valid], cov_t[..., far][valid])
    keep = torch.arange(nb, device=device) != bad
    ref = puf.update_model_lanes_plain(model, z, r, mu_t, cov_t, scal_any, aux_t, msc)
    assert max(errors([o[..., keep] for o in open_], [o[..., keep] for o in ref], cov_t[..., keep])) <= LIMIT[dtype]


# ---------------------------------------------------------------------------
# the wrapper's operands, on the CPU, against a stand-in for the kernel
# ---------------------------------------------------------------------------


class StandIn:
    """Records each launch and computes K3's function, as its C interface
    defines it, through the pointers it was given."""

    def __init__(self):
        self.calls = []

    def __call__(self, dtype, *args):
        self.calls.append(args)
        model_id, banked, z, r, mu, cov, scal, msc, aux, cov_out, mu_out, m2, acc, nu, nb, _ = args
        model = list(puf.FUSED_MODELS)[model_id]
        m = puf.FUSED_MODELS[model]
        lanes = lambda p, *shape: None if p is None else _strided(
            p, dtype, shape, tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape))))
        ref = puf.update_model_lanes_plain(
            model, lanes(z, m, nb), lanes(r, m, m, nb), lanes(mu, 54, nb), lanes(cov, N, N, nb), lanes(scal, 6, 1),
            lanes(aux, 5, nb) if banked else None, lanes(msc, 119, 1))
        for p, shape, value in zip((cov_out, mu_out, m2, acc, nu), ((N, N, nb), (54, nb), (1, nb), (1, nb), (m, nb)),
                                   ref):
            lanes(p, *shape).copy_(value)


@pytest.mark.parametrize("model", ["velocity", "body_efforts"])
@pytest.mark.parametrize("banked", [False, True], ids=["shared", "banked"])
def test_k3_wrapper_hands_the_kernel_its_operands_and_no_scratch(monkeypatch, model, banked):
    args = operands(model, 5, torch.float64, "cpu", banked, seed=1)
    fake, allocated, at_launch = StandIn(), [], []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: allocated.append(empty(*a, **kw)) or allocated[-1])
    monkeypatch.setattr(cuda_lib.KERNELS["pose_update_model"], "launch",
                        lambda *a: at_launch.extend(t.data_ptr() for t in allocated) or fake(*a))
    monkeypatch.setattr(cuda_lib, "stream_ptr", lambda device: None)
    out = puf.update_model_lanes_cuda(*args)
    (call,) = fake.calls
    assert len(call) == 16  # model, aux form, 7 operands, 5 outputs, bank, stream: no scratch
    assert call[2:7] == tuple(t.data_ptr() for t in args[1:6])  # z, R, μ, P, scal in place
    assert call[7] == (args[7].data_ptr() if model == "body_efforts" else None)
    assert call[8] == (args[6].data_ptr() if banked else None)
    assert call[9:14] == tuple(t.data_ptr() for t in out) == tuple(at_launch)  # the outputs are all it allocates
    ref = puf.update_model_lanes_plain(*args)
    for o, p in zip(out, ref):
        torch.testing.assert_close(o, p, rtol=0, atol=0, equal_nan=True)

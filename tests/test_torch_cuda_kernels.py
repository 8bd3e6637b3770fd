"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip where there is no GPU (there is no CPU mode
of a CUDA kernel). This file imports no JAX, so it runs on a GPU machine
without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances are normalized errors (see each test): float64 within 1e-9,
float32 within 2e-3 (107-point sums and a 53-column factorization rounded in
another order than PyTorch's library calls).
"""

import pytest
import torch

from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
from slam_uwv_kalman_filters_tpu_torch.models import pose_ukf as pukf
from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf
from slam_uwv_kalman_filters_tpu_torch.ops import dynamics as dyn
from slam_uwv_kalman_filters_tpu_torch.ops import kernels
from slam_uwv_kalman_filters_tpu_torch.parallel import bank
from slam_uwv_kalman_filters_tpu_torch.utils.config import default_pose_ukf_config

pytestmark = pytest.mark.cuda
LIMIT = {torch.float32: 2e-3, torch.float64: 1e-9}
NB = 130  # two blocks of 128 threads, the second ragged


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _bank(device, dtype):
    """Mission states with moved means and correlated covariances."""
    f64 = torch.float64
    gen = torch.Generator(device=device).manual_seed(3)
    state, params = pukf.init_from_pose(
        torch.zeros(3, dtype=f64), torch.eye(3, dtype=f64) * 0.01,
        torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=f64), torch.eye(3, dtype=f64) * 1e-4,
        default_pose_ukf_config(), dyn.default_uwv_parameters(), device=device,
    )
    bs = bank.replicate(state, NB)
    rn = lambda *s: torch.randn(*s, generator=gen, dtype=f64, device=device)
    g = rn(NB, 53, 53)
    c = g @ g.transpose(1, 2) / 53 + torch.eye(53, dtype=f64, device=device)
    s = torch.sqrt(torch.diagonal(c, dim1=1, dim2=2))
    sd = torch.sqrt(torch.diagonal(state.cov))
    bs = bs._replace(
        mu=bs.mu._replace(position=rn(NB, 3), velocity=rn(NB, 3) * 0.5),
        cov=c / (s[:, :, None] * s[:, None, :]) * sd[None, :, None] * sd[None, None, :],
        rotation_rate=rn(NB, 3) * 0.01,
    )
    to = lambda tree: bank.tree_map(lambda a: a.to(dtype), tree)
    return to(bs), to(params)


def _cov_err(out_t, ref_t, scale_t):
    n = out_t.shape[0]
    valid = torch.triu(torch.ones(n, n, dtype=torch.bool, device=out_t.device))
    d = torch.diagonal(scale_t, dim1=0, dim2=1).T.abs()
    err = (out_t - ref_t).abs() / torch.sqrt(d[:, None] * d[None, :])
    return err[valid].max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sigma_deltas_kernel_matches_plain(device, dtype):
    bs, _ = _bank(device, dtype)
    out, ref = kernels.sigma_deltas_cuda(bs.cov), kernels.sigma_deltas_plain(bs.cov)
    assert ((out - ref).abs() / ref.abs().amax(dim=(1, 2), keepdim=True)).max().item() <= LIMIT[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pose_predict_kernel_matches_plain(device, dtype):
    bs, params = _bank(device, dtype)
    ls = pf.to_lanes(bs)
    ops = pf._predict_operands_shared(params, 0.01, dtype)
    cov_k, mu_k = pf.predict_lanes_cuda(ls.cov_t, ls.mu_t, ls.rr_t, *ops)
    cov_p, mu_p = pf.predict_lanes_plain(ls.cov_t, ls.mu_t, ls.rr_t, *ops)
    assert _cov_err(cov_k, cov_p, cov_p) <= LIMIT[dtype]
    assert ((mu_k - mu_p).abs() / (1 + mu_p.abs())).max().item() <= LIMIT[dtype]


@pytest.mark.parametrize("banked", [False, True])
@pytest.mark.parametrize("model", list(puf.FUSED_MODELS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pose_update_kernel_matches_plain(device, dtype, model, banked):
    bs, params = _bank(device, dtype)
    ls = pf.to_lanes(bs)
    m = puf.FUSED_MODELS[model]
    gen = torch.Generator(device=device).manual_seed(5)
    z = torch.randn(m, NB, generator=gen, dtype=torch.float64, device=device).to(dtype)
    if model == "pressure":
        z = z * 50.0 + 101325.0
    r = (torch.eye(m, dtype=dtype, device=device) * 0.5)[..., None].expand(m, m, NB).contiguous()
    aux = {"pressure": (101325.0, 0.1, 0.2, -0.3), "water_velocity": (0.3,),
           "body_efforts": (0.01, 0.02, -0.01)}.get(model, ())
    aux_t = None
    if banked:
        aux_t = torch.zeros(5, NB, dtype=dtype, device=device)
        aux_t[: len(aux)] = torch.tensor(aux, dtype=dtype, device=device)[:, None]
        aux = ()
    thr = 5.991 if model in ("xy_position", "water_velocity") else None
    args = (model, z, r, ls.mu_t, ls.cov_t, puf._scal_block(thr, aux, dtype, device), aux_t,
            puf._efforts_model_scal(params, dtype) if model == "body_efforts" else None)
    ko, po = puf.update_model_lanes_cuda(*args), puf.update_model_lanes_plain(*args)
    assert _cov_err(ko[0], po[0], ls.cov_t) <= LIMIT[dtype]
    for k, p in zip(ko[1:], po[1:]):
        assert ((k - p).abs() / (1 + p.abs())).max().item() <= LIMIT[dtype]


def test_float32_kernel_means_are_as_accurate_as_plain(device):
    """K2's predicted mean and K3's measurement mean (through the innovation),
    held against the float64 plain version, err no more than the float32
    plain version's (×2, plus 2 ulp of the value). A running sum of 107
    gravities or pressures rounds at the value's scale and fails this; a mean
    about the zero point passes. (An updated state mean is not compared: its
    float32 error is the gain's, which rounds in another order in each.)"""
    bs64, params64 = _bank(device, torch.float64)
    bs32, params32 = bank.tree_map(lambda a: a.float(), bs64), bank.tree_map(lambda a: a.float(), params64)
    l64, l32 = pf.to_lanes(bs64), pf.to_lanes(bs32)
    ulp = torch.finfo(torch.float32).eps

    def assert_as_accurate(k32, p32, p64):
        err_k = (k32.double() - p64).abs().amax(-1)
        err_p = (p32.double() - p64).abs().amax(-1)
        assert (err_k <= 2 * err_p + 2 * ulp * p64.abs().amax(-1)).all(), (err_k, err_p)

    ops64 = pf._predict_operands_shared(params64, 0.01, torch.float64)
    ops32 = pf._predict_operands_shared(params32, 0.01, torch.float32)
    mu64 = pf.predict_lanes_plain(l64.cov_t, l64.mu_t, l64.rr_t, *ops64)[1]
    mu_p = pf.predict_lanes_plain(l32.cov_t, l32.mu_t, l32.rr_t, *ops32)[1]
    mu_k = pf.predict_lanes_cuda(l32.cov_t, l32.mu_t, l32.rr_t, *ops32)[1]
    assert_as_accurate(mu_k, mu_p, mu64)
    for model, z0, var, aux in (("acceleration", 9.8, 4e-5, ()), ("pressure", 101325.0, 2500.0, (101325.0, 0.0, 0.0, 0.0))):
        m = puf.FUSED_MODELS[model]
        z = torch.full((m, NB), z0, dtype=torch.float64, device=device)
        r = (torch.eye(m, dtype=torch.float64, device=device) * var)[..., None].expand(m, m, NB).contiguous()
        outs = []
        for fn, ls, dtype in ((puf.update_model_lanes_plain, l64, torch.float64),
                              (puf.update_model_lanes_plain, l32, torch.float32),
                              (puf.update_model_lanes_cuda, l32, torch.float32)):
            scal = puf._scal_block(None, aux, dtype, device)
            outs.append(fn(model, z.to(dtype), r.to(dtype), ls.mu_t, ls.cov_t, scal))
        (nu64, nu_p, nu_k) = (o[4] for o in outs)
        assert_as_accurate(nu_k, nu_p, nu64)


def test_wrapper_launches_and_counts(device):
    bs, params = _bank(device, torch.float32)
    counter = puf.cuda_lib.KERNELS["pose_predict"]
    before = counter.launches
    out = pf.predict_lanes(pf.to_lanes(bs), params, 0.01)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert torch.isfinite(pf.from_lanes(out, bs).cov).all()

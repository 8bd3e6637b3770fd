"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip where there is no GPU (there is no CPU mode
of a CUDA kernel). This file imports no JAX, so it runs on a GPU machine
without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances are normalized errors (see each test): float64 within 1e-9,
float32 within 2e-3 (107-point sums and a 53-column factorization rounded in
another order than PyTorch's library calls).

:func:`kernel_digests` hashes the outputs of K2 (shared mode) and K3 on fixed
operands; :data:`DIGESTS` holds what the kernels gave before K2 gained its
full mode and K3's update tail moved into ``csrc/common.cuh`` (the build of
that tree, NVIDIA H100 80GB HBM3), and the test holds the current build to it
bit for bit. The module imports only what that tree also had, so the same
function can hash its build.
"""

import hashlib

import numpy as np
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
        default_pose_ukf_config(), dyn.default_uwv_parameters(device=device), device=device,
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


def _nan_upper(cov_t):
    n = cov_t.shape[0]
    upper = torch.tril(torch.ones(n, n, dtype=torch.bool, device=cov_t.device), -1)[..., None]
    return torch.where(upper, float("nan"), cov_t).contiguous()


def _banked_operands(params, dtype, device):
    """Full-mode predict operands of a banked draw that moves every per-lane
    operand: process noise, current scale, time constants, rest points and
    the projection anchor."""
    gen = torch.Generator(device=device).manual_seed(9)
    draw = lambda *s: 1.0 + 0.2 * torch.randn(NB, *s, generator=gen, dtype=torch.float64, device=device).clamp(-3, 3).to(dtype)
    bp = bank.tree_map(lambda x: x.expand(NB, *x.shape), params)
    bp = bp._replace(
        process_noise=bp.process_noise * draw()[:, None, None],
        water_velocity_scale=bp.water_velocity_scale * draw(),
        gyro_bias_tau=bp.gyro_bias_tau * draw(), quad_damping_tau=bp.quad_damping_tau * draw(),
        inertia_offset=bp.inertia_offset * draw(3, 3),
        projection=bp.projection._replace(lat0=bp.projection.lat0 * draw()),
    )
    return pf.banked_predict_operands(bp, 0.01, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pose_predict_full_kernel_matches_plain(device, dtype):
    bs, params = _bank(device, dtype)
    ls = pf.to_lanes(bs)
    bo = _banked_operands(params, dtype, device)
    args = (_nan_upper(ls.cov_t), ls.mu_t, ls.rr_t, bo.coeff, bo.offs, bo.q0m_t, bo.scal, bo.aux_t)
    cov_k, mu_k = pf.predict_lanes_cuda(*args)
    cov_p, mu_p = pf.predict_lanes_plain(*args)
    assert _cov_err(cov_k, cov_p, cov_p) <= LIMIT[dtype]
    assert ((mu_k - mu_p).abs() / (1 + mu_p.abs())).max().item() <= LIMIT[dtype]


def _tail_operands(device, dtype, m, thr):
    """K4 operands on predicted mission states: every 7th instance fails the
    gate; with a threshold ≥ 0 instance 5's S is NaN."""
    bs, params = _bank(device, dtype)
    ls = pf.to_lanes(bs)
    cov_p, mu_p = pf.predict_lanes_plain(ls.cov_t, ls.mu_t, ls.rr_t, *pf._predict_operands_shared(params, 0.01, dtype))
    cov_p = _nan_upper(cov_p)
    gen = torch.Generator(device=device).manual_seed(10 + m)
    rn = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64, device=device).to(dtype)
    dz = 0.1 * rn(pf.NSIG, m, NB)
    nu = 0.3 * rn(m, NB)
    nu[:, ::7] += 10.0
    r = (torch.eye(m, dtype=dtype, device=device) * 0.05)[..., None].repeat(1, 1, NB)
    if thr >= 0:
        r[0, 0, 5] = float("nan")
    return (kernels.sigma_deltas_lanes_plain(cov_p), (dz - dz.mean(0)).contiguous(), nu.contiguous(), r,
            mu_p, cov_p, thr)


@pytest.mark.parametrize("thr", [-1.0, 5.991])
@pytest.mark.parametrize("m", [1, 2, 3, 6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pose_update_tail_kernel_matches_plain(device, dtype, m, thr):
    args = _tail_operands(device, dtype, m, thr)
    ko, po = puf.update_tail_cuda(*args), puf.update_tail_plain(*args)
    assert _cov_err(ko[0], po[0], args[5]) <= LIMIT[dtype]
    assert ((ko[1] - po[1]).abs() / (1 + po[1].abs())).max().item() <= LIMIT[dtype]
    both_nan = torch.isnan(ko[2]) & torch.isnan(po[2])
    assert torch.equal(torch.isnan(ko[2]), torch.isnan(po[2]))
    assert (torch.where(both_nan, 0.0, (ko[2] - po[2]).abs() / (1 + po[2].abs()))).max().item() <= LIMIT[dtype]
    assert torch.equal(ko[3], po[3])
    if thr >= 0:  # the NaN-S instance keeps its prior, bit for bit
        valid = torch.triu(torch.ones(53, 53, dtype=torch.bool, device=device))
        assert ko[3][0, 5] == 0.0
        assert torch.equal(ko[0][..., 5][valid], args[5][..., 5][valid])
        assert torch.equal(ko[1][:, 5], args[4][:, 5])


def test_float32_update_tail_as_accurate_as_plain(device):
    """The generic-h route (K1, h in PyTorch, K4) in float32 against the
    float64 plain route: the innovation and the NIS no less accurate than the
    float32 plain route's (×2, plus 2 ulp of the value), the criterion of
    the means test above. The measurement mean and innovation come from
    PyTorch in both routes; K4's sums enter the NIS through S."""
    bs64, params64 = _bank(device, torch.float64)
    bs32 = bank.tree_map(lambda a: a.float(), bs64)
    ulp = torch.finfo(torch.float32).eps
    h = lambda s: pukf._h_pressure(torch.tensor(101325.0, dtype=s.position.dtype, device=device),
                                   torch.zeros(3, dtype=s.position.dtype, device=device))(s)
    z = torch.full((NB, 1), 101325.0, dtype=torch.float64, device=device)
    r = torch.eye(1, dtype=torch.float64, device=device) * 2500.0
    routes = []
    for bs, cuda in ((bs64, False), (bs32, False), (bs32, True)):
        fn = puf._pose_update_lanes if cuda else (lambda *a: puf.update_tail_plain(*a))
        with_route = pytest.MonkeyPatch()
        with_route.setattr(puf, "_pose_update_lanes", fn)
        if not cuda:
            with_route.setattr(puf, "sigma_deltas_lanes", kernels.sigma_deltas_lanes_plain)
        try:
            _, info = puf.update_lanes(pf.to_lanes(bs), None, z.to(bs.cov.dtype), r.to(bs.cov.dtype), h,
                                       pukf._PRESSURE_DEPS)
        finally:
            with_route.undo()
        routes.append(info)
    for field in ("innovation", "mahalanobis2"):
        ref, p32, k32 = (getattr(i, field).double().reshape(NB, -1).T for i in routes)  # (m, bank)
        err_k, err_p = (k32 - ref).abs().amax(-1), (p32 - ref).abs().amax(-1)
        assert (err_k <= 2 * err_p + 2 * ulp * ref.abs().amax(-1)).all(), (field, err_k, err_p)


def kernel_digests(device) -> dict:
    """sha256 (first 16 hex digits) of K2's shared-mode outputs and K3's
    outputs — valid covariance half, mean, NIS, gate, innovation — for all
    seven models in both aux forms, float32 and float64, on fixed operands
    made from a seeded numpy Generator."""
    f64 = torch.float64
    state, params = pukf.init_from_pose(
        torch.zeros(3, dtype=f64), torch.eye(3, dtype=f64) * 0.01,
        torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=f64), torch.eye(3, dtype=f64) * 1e-4,
        default_pose_ukf_config(), dyn.default_uwv_parameters(device="cpu"), device="cpu",
    )
    rng = np.random.default_rng(2024)
    n = 53
    g = rng.normal(size=(NB, n, n))
    c = g @ np.swapaxes(g, 1, 2) / n + np.eye(n)
    sd = np.sqrt(np.diagonal(c, axis1=1, axis2=2))
    scale = np.sqrt(np.diag(state.cov.numpy()))
    cov = c / (sd[:, :, None] * sd[:, None, :]) * scale[None, :, None] * scale[None, None, :]
    mu = np.tile(pf._pack_storage(bank.tree_map(lambda a: a[None], state.mu)).numpy(), (NB, 1))
    mu[:, 0:3] += rng.normal(size=(NB, 3))
    mu[:, 7:10] = 0.5 * rng.normal(size=(NB, 3))
    yaw = 0.3 * rng.normal(size=NB)
    mu[:, 3], mu[:, 6] = np.cos(yaw / 2), np.sin(yaw / 2)
    rr = 0.01 * rng.normal(size=(3, NB))
    zs = {model: rng.normal(size=(m, NB)) for model, m in puf.FUSED_MODELS.items()}
    auxb = 0.01 * rng.normal(size=(5, NB))
    valid = torch.triu(torch.ones(n, n, dtype=torch.bool)).to(device)
    out = {}
    for dtype in (torch.float32, torch.float64):
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)
        cov_t, mu_t, rr_t = t(np.transpose(cov, (2, 1, 0))), t(mu.T), t(rr)
        p = bank.tree_map(lambda a: a.to(device=device, dtype=dtype), params)

        def digest(tensors):
            h = hashlib.sha256()
            for x in tensors:
                x = x[valid] if x.ndim == 3 and x.shape[:2] == (n, n) else x
                h.update(x.detach().cpu().numpy().tobytes())
            return h.hexdigest()[:16]

        name = str(dtype).split(".")[-1]
        ops = pf._predict_operands_shared(p, 0.01, dtype)
        out[f"pose_predict,{name}"] = digest(pf.predict_lanes_cuda(cov_t, mu_t, rr_t, *ops))
        mscal = puf._efforts_model_scal(p, dtype)
        for model, m in puf.FUSED_MODELS.items():
            z = t(zs[model] * 50.0 + 101325.0 if model == "pressure" else zs[model])
            r = (torch.eye(m, dtype=dtype, device=device) * 0.5)[..., None].expand(m, m, NB).contiguous()
            aux = {"pressure": (101325.0, 0.1, 0.2, -0.3), "water_velocity": (0.3,),
                   "body_efforts": (0.01, 0.02, -0.01)}.get(model, ())
            thr = 5.991 if model in ("xy_position", "water_velocity") else None
            for form in ("shared", "banked"):
                aux_t = None
                if form == "banked":
                    aux_t = t(auxb + np.asarray(list(aux) + [0.0] * (5 - len(aux)))[:, None])
                scal = puf._scal_block(thr, aux if form == "shared" else (), dtype, device)
                args = (model, z, r, mu_t, cov_t, scal, aux_t, mscal if model == "body_efforts" else None)
                out[f"pose_update_model[{model},{form}],{name}"] = digest(puf.update_model_lanes_cuda(*args))
    return out


# kernel_digests of the build before the full mode and the shared tail
# (NVIDIA H100 80GB HBM3, CUDA 12.8, PyTorch 2.11); a change of either kernel's
# arithmetic, or of the compiler, changes them
DIGESTS = {
    "pose_predict,float32": "c0ee321fe6202ad9",
    "pose_predict,float64": "b41fcf91155bc130",
    "pose_update_model[acceleration,banked],float32": "2abae6bf680571b5",
    "pose_update_model[acceleration,banked],float64": "3b0ffbaa03085ebb",
    "pose_update_model[acceleration,shared],float32": "2abae6bf680571b5",
    "pose_update_model[acceleration,shared],float64": "3b0ffbaa03085ebb",
    "pose_update_model[body_efforts,banked],float32": "bab8ec4a0d708c0b",
    "pose_update_model[body_efforts,banked],float64": "5619ec6a58c453db",
    "pose_update_model[body_efforts,shared],float32": "722b4faefca16b67",
    "pose_update_model[body_efforts,shared],float64": "e394ec7bc4f0c80a",
    "pose_update_model[pressure,banked],float32": "a885d3dab12a2490",
    "pose_update_model[pressure,banked],float64": "2d8a7a6ce03e0e89",
    "pose_update_model[pressure,shared],float32": "99f07c06c047a450",
    "pose_update_model[pressure,shared],float64": "b056f1818f5c467e",
    "pose_update_model[velocity,banked],float32": "7344e21cf153964d",
    "pose_update_model[velocity,banked],float64": "9a2148343cc264c2",
    "pose_update_model[velocity,shared],float32": "7344e21cf153964d",
    "pose_update_model[velocity,shared],float64": "9a2148343cc264c2",
    "pose_update_model[water_velocity,banked],float32": "a397821aa4fb1668",
    "pose_update_model[water_velocity,banked],float64": "c5ed6d4e3fdbf4f3",
    "pose_update_model[water_velocity,shared],float32": "9dd4add66bb652c5",
    "pose_update_model[water_velocity,shared],float64": "402dbcbde6eec9f7",
    "pose_update_model[xy_position,banked],float32": "5c8b1d82da28f98d",
    "pose_update_model[xy_position,banked],float64": "203e5e69d8dada19",
    "pose_update_model[xy_position,shared],float32": "5c8b1d82da28f98d",
    "pose_update_model[xy_position,shared],float64": "203e5e69d8dada19",
    "pose_update_model[z_position,banked],float32": "d910f26f47ad1657",
    "pose_update_model[z_position,banked],float64": "cf2968bbe8ed7e94",
    "pose_update_model[z_position,shared],float32": "d910f26f47ad1657",
    "pose_update_model[z_position,shared],float64": "cf2968bbe8ed7e94",
}


def test_k2_shared_and_k3_bit_identical_to_before_the_tail_move(device):
    got = kernel_digests(device)
    assert DIGESTS, "no recorded digests"
    differ = {k: (got[k], v) for k, v in DIGESTS.items() if got.get(k) != v}
    assert not differ, differ


def test_wrapper_launches_and_counts(device):
    bs, params = _bank(device, torch.float32)
    counter = puf.cuda_lib.KERNELS["pose_predict"]
    before = counter.launches
    out = pf.predict_lanes(pf.to_lanes(bs), params, 0.01)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert torch.isfinite(pf.from_lanes(out, bs).cov).all()

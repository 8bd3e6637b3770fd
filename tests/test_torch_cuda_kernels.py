"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip where there is no GPU (there is no CPU mode
of a CUDA kernel). This file imports no JAX, so it runs on a GPU machine
without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

K5 (the whole PoseUKF step) is also held to the K2 → K3 chain it composes,
and K5's and K6's float32 means to the plain float32 accuracy.

Tolerances are normalized errors (see each test): float64 within 1e-9,
float32 within 2e-3 (107-point sums and a 53-column factorization rounded in
another order than PyTorch's library calls).

:func:`kernel_digests` hashes the outputs of K2 (both modes), K3, K4, K5 and
K11 on fixed operands; :data:`DIGESTS` holds what K2's shared mode and K3 gave
before K2 gained its full mode and K3's update tail moved into
``csrc/common.cuh``, what K2's full mode and K5 gave before both moved to one
warp per instance, and what K4 and K11 gave before they did (the builds of
those trees, NVIDIA H100 80GB HBM3),
and the test holds the current build to them bit for bit; :func:`velocity_digests` and :data:`VELOCITY_DIGESTS` do the
same for K6 across the move of its Crout factor, substitutions and Kalman
tail into ``csrc/small_ukf.cuh``. The module imports at its top only what
those trees also had (later modules inside the tests), so the same functions
can hash their builds. K7 (the BottomUKF step) and K8 (the banked SPD solve)
are held to their plain versions, K8's error measured on D·X, D = √diag A;
so are K9 and K10 (the IndirectPoseUKF's predict and marker update) at bank
300, with one and four corners, shared and per-instance marker data, and K11
(the PoseUKF's 59-DOF marker update) the same way, with pad lanes and the
routing of a CUDA bank's ``update_visual_features_bank`` through it.
"""

import hashlib
import sys
from pathlib import Path

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


def kernel_digests(device, outputs: dict | None = None) -> dict:
    """sha256 (first 16 hex digits) of K2's outputs in both modes, K3's
    outputs — valid covariance half, mean, NIS, gate, innovation — for all
    seven models in both aux forms, and K5's on two gated chains, float32 and
    float64, on fixed operands made from a seeded numpy Generator (the draws
    of the full mode's per-instance operands and of the chains come after
    the others, so adding them moved no earlier operand). ``outputs``, when
    given, also receives each key's output tensors on the CPU, to locate a
    drift entry by entry. Since the build before K11 and K4 moved to one warp
    per instance it also hashes K4's outputs for m = 1, 2, 3, 6 with open and
    rejecting gates and a NaN S, and K11's with 1 and 4 corners, shared and
    per-instance marker data (``chip_smoke.marker_check_operands``)."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_marker_fused as pmf

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
    # full mode: every per-instance operand moved (process noise, current
    # scale, time constants, rest points, projection anchor)
    draws = {key: 1.0 + 0.2 * np.clip(rng.normal(size=(NB, *shape)), -3, 3)
             for key, shape in (("noise", ()), ("wv", ()), ("gyro", ()), ("quad", ()), ("inertia", (3, 3)),
                                ("lat0", ()))}
    # K4: a generic-h update of m <= 6 rows about the covariance's own
    # sigma deltas, dz = H·δ + noise, every 7th innovation far out
    lc = np.linalg.cholesky(cov)  # (NB, n, n)
    cols = np.transpose(lc, (2, 1, 0))  # (j, k, NB): column j of L at row k
    deltas = np.concatenate([np.zeros((1, n, NB)), cols, -cols])
    h = 0.3 * rng.normal(size=(6, n))
    dz_all = np.einsum("in,pnb->pib", h, deltas) + 0.01 * rng.normal(size=(2 * n + 1, 6, NB))
    nu_all = 0.3 * rng.normal(size=(6, NB))
    nu_all[:, ::7] += 10.0
    chains = (("acceleration", "velocity"), ("acceleration", "velocity", "pressure", "water_velocity"))
    gates = {"acceleration": 7.815, "velocity": 7.815, "pressure": None, "water_velocity": 5.991}
    valid = torch.triu(torch.ones(n, n, dtype=torch.bool)).to(device)
    out = {}
    for dtype in (torch.float32, torch.float64):
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)
        cov_t, mu_t, rr_t = t(np.transpose(cov, (2, 1, 0))), t(mu.T), t(rr)
        p = bank.tree_map(lambda a: a.to(device=device, dtype=dtype), params)

        def digest(tensors):
            h = hashlib.sha256()
            kept = []
            for x in tensors:
                x = x[valid] if x.ndim == 3 and x.shape[:2] == (n, n) else x
                kept.append(x.detach().cpu())
                h.update(kept[-1].numpy().tobytes())
            return h.hexdigest()[:16], kept

        def record(key, tensors):
            out[key], kept = digest(tensors)
            if outputs is not None:
                outputs[key] = kept

        name = str(dtype).split(".")[-1]
        ops = pf._predict_operands_shared(p, 0.01, dtype)
        record(f"pose_predict,{name}", pf.predict_lanes_cuda(cov_t, mu_t, rr_t, *ops))
        d = {key: torch.as_tensor(v, device=device).to(dtype) for key, v in draws.items()}
        bp = bank.tree_map(lambda x: x.expand(NB, *x.shape), p)
        bp = bp._replace(
            process_noise=bp.process_noise * d["noise"][:, None, None],
            water_velocity_scale=bp.water_velocity_scale * d["wv"],
            gyro_bias_tau=bp.gyro_bias_tau * d["gyro"], quad_damping_tau=bp.quad_damping_tau * d["quad"],
            inertia_offset=bp.inertia_offset * d["inertia"],
            projection=bp.projection._replace(lat0=bp.projection.lat0 * d["lat0"]),
        )
        bo = pf.banked_predict_operands(bp, 0.01, dtype)
        record(f"pose_predict_full,{name}",
               pf.predict_lanes_cuda(cov_t, mu_t, rr_t, bo.coeff, bo.offs, bo.q0m_t, bo.scal, bo.aux_t))
        for chain in chains:
            z_ts, r_ts, s6 = [], [], []
            for model in chain:
                m = puf.FUSED_MODELS[model]
                z = zs[model] * 50.0 + 101325.0 if model == "pressure" else zs[model].copy()
                if model == "acceleration":
                    z[2] += 9.81  # about the predicted specific force
                z_ts.append(t(z))
                var = 2500.0 if model == "pressure" else 0.5
                r_ts.append((torch.eye(m, dtype=dtype, device=device) * var)[..., None].expand(m, m, NB).contiguous())
                aux = {"pressure": (101325.0, 0.1, 0.2, -0.3), "water_velocity": (0.3,)}.get(model, ())
                s6.append(puf._scal_block(gates[model], aux, dtype, device).T)
            cov_k, mu_k, infos = puf.pose_step_lanes_cuda(chain, cov_t, mu_t, rr_t, *ops, z_ts, r_ts, torch.cat(s6).contiguous())
            record(f"pose_step[{'+'.join(chain)}],{name}", [cov_k, mu_k, *(x for info in infos for x in info)])
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
                record(f"pose_update_model[{model},{form}],{name}", puf.update_model_lanes_cuda(*args))
        # K4 for m = 1, 2, 3, 6: every gate open (threshold < 0), then χ²
        # gates that reject every 7th instance, with instance 5's S NaN
        for m in (1, 2, 3, 6):
            for thr in (-1.0, 5.991):
                r = (torch.eye(m, dtype=dtype, device=device) * 0.05)[..., None].repeat(1, 1, NB)
                if thr >= 0:
                    r[0, 0, 5] = float("nan")
                args = (t(deltas), t(dz_all[:, :m]), t(nu_all[:m]), r, mu_t, cov_t, thr)
                record(f"pose_update_tail[m={m},thr={thr:g}],{name}", puf.update_tail_cuda(*args))
        # K11 on chip_smoke.py's check operands at this ragged bank
        for k, per_instance in ((1, False), (1, True), (4, False), (4, True)):
            args = chip_smoke().marker_check_operands(NB, dtype, device,
                                                      torch.Generator(device=device).manual_seed(43), k, per_instance)
            record(f"pose_markers[k={k},{'per-instance' if per_instance else 'shared'}],{name}",
                   pmf.pose_markers_lanes_cuda(*args))
    return out


def chip_smoke():
    """The repository's chip_smoke module (its K11 check operands), found
    beside tests/ when the working directory is elsewhere."""
    try:
        import chip_smoke as module
    except ImportError:
        sys.path.append(str(Path(__file__).resolve().parent.parent))
        import chip_smoke as module
    return module


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
    # K2's full mode and K5 from the build of the tree before both moved to
    # one warp per instance (the one-thread bodies; same card and toolchain)
    "pose_predict_full,float32": "ed46a742ce897b8e",
    "pose_predict_full,float64": "2a935d472e10f442",
    "pose_step[acceleration+velocity+pressure+water_velocity],float32": "419a86a86c95de86",
    "pose_step[acceleration+velocity+pressure+water_velocity],float64": "5f33dab9092ad2ec",
    "pose_step[acceleration+velocity],float32": "89217f5405f6d5f1",
    "pose_step[acceleration+velocity],float64": "02639ba59025c10f",
    # K4 and K11 from the build of the tree before both moved to one warp per
    # instance (the one-thread kernels; NVIDIA H100 80GB HBM3, CUDA 12.8,
    # PyTorch 2.11)
    "pose_markers[k=1,per-instance],float32": "397d9bc9568921df",
    "pose_markers[k=1,per-instance],float64": "076fe12a40aeb6e1",
    "pose_markers[k=1,shared],float32": "bf5e6a660c37232e",
    "pose_markers[k=1,shared],float64": "c51d0406d2fc37bf",
    "pose_markers[k=4,per-instance],float32": "934bdf47f86c55ad",
    "pose_markers[k=4,per-instance],float64": "af11390de259f6a6",
    "pose_markers[k=4,shared],float32": "761d4e476a17bfef",
    "pose_markers[k=4,shared],float64": "1cfe8fcdd5bc2213",
    "pose_update_tail[m=1,thr=-1],float32": "00c1cdc36cc698ba",
    "pose_update_tail[m=1,thr=-1],float64": "9e54c983d458b692",
    "pose_update_tail[m=1,thr=5.991],float32": "1d2e32d27ae31d61",
    "pose_update_tail[m=1,thr=5.991],float64": "79f9d4b6429c1b4f",
    "pose_update_tail[m=2,thr=-1],float32": "920b88188aba0f3f",
    "pose_update_tail[m=2,thr=-1],float64": "520186bc2c39279f",
    "pose_update_tail[m=2,thr=5.991],float32": "51df763986ba4cb7",
    "pose_update_tail[m=2,thr=5.991],float64": "363b287cd551cd89",
    "pose_update_tail[m=3,thr=-1],float32": "084344ba079bc57e",
    "pose_update_tail[m=3,thr=-1],float64": "5c9d95d6b3fcb48b",
    "pose_update_tail[m=3,thr=5.991],float32": "0cbae5db265d5b5d",
    "pose_update_tail[m=3,thr=5.991],float64": "cecbc55d4cf918ba",
    "pose_update_tail[m=6,thr=-1],float32": "73c7bf918decfd20",
    "pose_update_tail[m=6,thr=-1],float64": "e5d8e14c5082fee4",
    "pose_update_tail[m=6,thr=5.991],float32": "6d85c66630713091",
    "pose_update_tail[m=6,thr=5.991],float64": "688662f09f8dd946",
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


# ---------------------------------------------------------------------------
# K5 (the whole PoseUKF step) and K6 (the whole VelocityUKF step)
# ---------------------------------------------------------------------------


def _rel(a, b):
    return ((a - b).abs() / (1 + b.abs())).max().item()


def _step_operands(device, dtype, models=puf.STEP_MODELS, z0=None):
    """K5 operands: the six-model chain on mission states, NaN in the
    invalid covariance half, instance 0 pushed out of the χ²-95 gate of
    xy_position and water_velocity. ``z0`` sets every z to a constant."""
    bs, params = _bank(device, dtype)
    ls = pf.to_lanes(bs)
    gen = torch.Generator(device=device).manual_seed(12)
    z_ts, r_ts, s6 = [], [], []
    var = {"velocity": 1e-3, "z_position": 0.01, "xy_position": 0.5, "acceleration": 4e-5,
           "pressure": 2500.0, "water_velocity": 1e-3}
    for model in models:
        m = puf.FUSED_MODELS[model]
        if z0 is None:
            z = torch.randn(m, NB, generator=gen, dtype=torch.float64, device=device)
            z = z * 50.0 + 101325.0 if model == "pressure" else z
        else:
            z = torch.full((m, NB), z0[model], dtype=torch.float64, device=device)
        thr = 5.991 if model in ("xy_position", "water_velocity") else None
        if thr is not None:
            z[:, 0] += 30.0
        z_ts.append(z.to(dtype).contiguous())
        r_ts.append((torch.eye(m, dtype=dtype, device=device) * var[model])[..., None].expand(m, m, NB).contiguous())
        aux = {"pressure": (101325.0, 0.1, 0.2, -0.3), "water_velocity": (0.3,)}.get(model, ())
        s6.append(puf._scal_block(thr, aux, dtype, device).T)
    return (tuple(models), _nan_upper(ls.cov_t), ls.mu_t, ls.rr_t, *pf._predict_operands_shared(params, 0.01, dtype),
            z_ts, r_ts, torch.cat(s6).contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pose_step_kernel_matches_plain(device, dtype):
    args = _step_operands(device, dtype)
    ko, po = puf.pose_step_lanes_cuda(*args), puf.pose_step_lanes_plain(*args)
    prior = pf.predict_lanes_plain(*args[1:8])[0]  # the updates' prior normalizes, as for K3
    assert _cov_err(ko[0], po[0], prior) <= LIMIT[dtype]
    assert _rel(ko[1], po[1]) <= LIMIT[dtype]
    for (km2, kacc, knu), (pm2, pacc, pnu) in zip(ko[2], po[2]):
        assert torch.equal(kacc, pacc)
        assert max(_rel(km2, pm2), _rel(knu, pnu)) <= LIMIT[dtype]
    assert ko[2][2][1][0, 0] == 0.0 and ko[2][5][1][0, 0] == 0.0  # the gated instance 0 rejected


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pose_step_kernel_matches_k2_k3_chain(device, dtype):
    """K5 against K2 followed by one K3 launch per update, on the same
    operands (the same two bodies, composed in one launch)."""
    models, cov_t, mu_t, rr_t, coeff, offs, q0m, scal, z_ts, r_ts, scal6 = _step_operands(device, dtype)
    ko = puf.pose_step_lanes_cuda(models, cov_t, mu_t, rr_t, coeff, offs, q0m, scal, z_ts, r_ts, scal6)
    cov, mu = pf.predict_lanes_cuda(cov_t, mu_t, rr_t, coeff, offs, q0m, scal)
    for k, model in enumerate(models):
        cov, mu, m2, acc, nu = puf.update_model_lanes_cuda(model, z_ts[k], r_ts[k], mu, cov, scal6[k][:, None].contiguous())
        assert torch.equal(ko[2][k][1], acc)
    prior = pf.predict_lanes_plain(cov_t, mu_t, rr_t, coeff, offs, q0m, scal)[0]
    assert _cov_err(ko[0], cov, prior) <= LIMIT[dtype]
    assert _rel(ko[1], mu) <= LIMIT[dtype]


def _velocity_operands(device, dtype):
    """K6 operands on a bank away from rest (efforts, gyro, tracker
    orientations, a vehicle with live restoring terms); a DVL z that instance
    0 fails the χ²-95 gate with, a depth z accepted."""
    from slam_uwv_kalman_filters_tpu_torch.models import velocity_fused as vf
    from slam_uwv_kalman_filters_tpu_torch.models import velocity_ukf as vu

    rng = np.random.default_rng(13)
    t = lambda a: torch.as_tensor(np.asarray(a), device=device).to(dtype)
    g = rng.normal(size=(NB, 4, 4))
    q = rng.normal(size=(NB, 4)) * [1.0, 0.2, 0.2, 0.4] + [2.0, 0.0, 0.0, 0.0]
    st = vu.VelocityUKFState(
        vu.VelocityState(t(rng.normal(0.0, 0.5, (NB, 3))), t(rng.normal(0.0, 2.0, (NB, 1)))),
        t(0.02 * (g @ np.swapaxes(g, 1, 2) / 4 + np.eye(4))), t(rng.normal(0.0, 30.0, (NB, 6))),
        t(rng.normal(0.0, 0.05, (NB, 3))),
        dyn.PoseVelocityState(t(rng.normal(size=(NB, 3))), t(q / np.linalg.norm(q, axis=1, keepdims=True)),
                              t(rng.normal(0.0, 0.5, (NB, 3))), t(rng.normal(0.0, 0.05, (NB, 3)))),
    )
    model = bank.tree_map(lambda a: a.to(dtype), dyn.default_uwv_parameters(device=device))
    model = model._replace(weight=t(1000.0), cog=t([0.01, -0.02, 0.05]), cob=t([0.0, 0.01, -0.03]))
    params = vu.VelocityUKFParams(model, vu.default_process_noise(dtype, device))
    ls = vf.to_lanes(st)
    z = (ls.mu_t[:3] + 0.05).contiguous()
    z[:, 0] += 3.0
    r3 = (torch.eye(3, dtype=dtype, device=device) * 0.01)[..., None].expand(3, 3, NB).contiguous()
    r1 = (torch.eye(1, dtype=dtype, device=device) * 0.04)[..., None].expand(1, 1, NB).contiguous()
    base = (ls.cov_t, ls.mu_t, ls.eff_t, ls.av_t, ls.trk_t, vf.params_block(params, 0.05, dtype))
    return {
        "predict": ((), True, *base, [], [], []),
        "update": (("dvl",), False, *base, [z], [r3], [7.815]),
        "predict+dvl+pressure": (("dvl", "pressure"), True, *base, [z, (ls.mu_t[3:] + 0.1).contiguous()], [r3, r1],
                                 [7.815, -1.0]),
    }


@pytest.mark.parametrize("case", ["predict", "update", "predict+dvl+pressure"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_velocity_step_kernel_matches_plain(device, dtype, case):
    from slam_uwv_kalman_filters_tpu_torch.models import velocity_fused as vf

    args = _velocity_operands(device, dtype)[case]
    ko, po = vf.velocity_step_lanes_cuda(*args), vf.velocity_step_lanes_plain(*args)
    for k, p in zip(ko[:3], po[:3]):
        assert _rel(k, p) <= LIMIT[dtype]
    for (km2, kacc, knu), (pm2, pacc, pnu) in zip(ko[3], po[3]):
        assert torch.equal(kacc, pacc)
        assert max(_rel(km2, pm2), _rel(knu, pnu)) <= LIMIT[dtype]
    if args[0]:
        assert ko[3][0][1][0, 0] == 0.0 and bool((ko[3][0][1][0, 1:] == 1.0).all())


def test_float32_step_kernel_means_are_as_accurate_as_plain(device):
    """K5's innovations (the predicted and updated means enter them) on an
    [acceleration, pressure] chain at z ≈ g and z ≈ 1e5 Pa, and K6's
    predicted mean and DVL innovation, against float64 plain: no worse than
    the float32 plain version (×2, plus 2 ulp of the value), the criterion of
    the K2 / K3 test above."""
    from slam_uwv_kalman_filters_tpu_torch.models import velocity_fused as vf

    ulp = torch.finfo(torch.float32).eps

    def assert_as_accurate(k32, p32, p64):
        err_k = (k32.double() - p64).abs().amax(-1)
        err_p = (p32.double() - p64).abs().amax(-1)
        assert (err_k <= 2 * err_p + 2 * ulp * p64.abs().amax(-1)).all(), (err_k, err_p)

    z0 = {"acceleration": 9.8, "pressure": 101325.0}
    a64 = _step_operands(device, torch.float64, ("acceleration", "pressure"), z0)
    a32 = _step_operands(device, torch.float32, ("acceleration", "pressure"), z0)
    n64, p32, k32 = (puf.pose_step_lanes_plain(*a64)[2], puf.pose_step_lanes_plain(*a32)[2],
                     puf.pose_step_lanes_cuda(*a32)[2])
    for k in range(2):
        assert_as_accurate(k32[k][2], p32[k][2], n64[k][2])
    v64 = _velocity_operands(device, torch.float64)["predict+dvl+pressure"]
    v32 = _velocity_operands(device, torch.float32)["predict+dvl+pressure"]
    o64, o32, ok32 = (vf.velocity_step_lanes_plain(*v64), vf.velocity_step_lanes_plain(*v32),
                      vf.velocity_step_lanes_cuda(*v32))
    assert_as_accurate(ok32[3][0][2], o32[3][0][2], o64[3][0][2])
    pred = [fn((), True, *v[2:8], [], [], []) for fn, v in ((vf.velocity_step_lanes_plain, v64),
                                                                   (vf.velocity_step_lanes_plain, v32),
                                                                   (vf.velocity_step_lanes_cuda, v32))]
    assert_as_accurate(pred[2][1], pred[1][1], pred[0][1])


# ---------------------------------------------------------------------------
# K6's arithmetic across the move of its Crout factor, substitutions and
# Kalman tail into csrc/small_ukf.cuh (shared with K7)
# ---------------------------------------------------------------------------


def velocity_digests(device) -> dict:
    """sha256 (first 16 hex digits) of K6's outputs — covariance, mean,
    tracker, NIS, gate, innovation — predict-only, update-only and predict +
    [DVL, pressure] with a rejecting gate, float32 and float64, on fixed
    operands made from a seeded numpy Generator."""
    from slam_uwv_kalman_filters_tpu_torch.models import velocity_fused as vf
    from slam_uwv_kalman_filters_tpu_torch.models import velocity_ukf as vu

    rng = np.random.default_rng(2025)
    g = rng.normal(size=(NB, 4, 4))
    q = rng.normal(size=(NB, 4)) * [1.0, 0.2, 0.2, 0.4] + [2.0, 0.0, 0.0, 0.0]
    cov = 0.02 * (g @ np.swapaxes(g, 1, 2) / 4 + np.eye(4))
    mu = np.concatenate([rng.normal(0.0, 0.5, (NB, 3)), rng.normal(0.0, 2.0, (NB, 1))], axis=1)
    eff, av = rng.normal(0.0, 30.0, (NB, 6)), rng.normal(0.0, 0.05, (NB, 3))
    trk = np.concatenate([rng.normal(size=(NB, 3)), q / np.linalg.norm(q, axis=1, keepdims=True),
                          rng.normal(0.0, 0.5, (NB, 3)), av], axis=1)
    z = mu[:, :3] + 0.05
    z[0] += 3.0
    out = {}
    for dtype in (torch.float32, torch.float64):
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)
        model = bank.tree_map(lambda a: a.to(dtype), dyn.default_uwv_parameters(device=device))
        model = model._replace(weight=torch.tensor(1000.0, dtype=dtype, device=device), cog=t([0.01, -0.02, 0.05]),
                               cob=t([0.0, 0.01, -0.03]))
        scal = vf.params_block(vu.VelocityUKFParams(model, vu.default_process_noise(dtype, device)), 0.05, dtype)
        base = (t(np.transpose(cov, (2, 1, 0))), t(mu.T), t(eff.T), t(av.T), t(trk.T), scal)
        r3 = (torch.eye(3, dtype=dtype, device=device) * 0.01)[..., None].expand(3, 3, NB).contiguous()
        r1 = (torch.eye(1, dtype=dtype, device=device) * 0.04)[..., None].expand(1, 1, NB).contiguous()
        cases = {
            "predict": ((), True, *base, [], [], []),
            "update": (("dvl",), False, *base, [t(z.T)], [r3], [7.815]),
            "predict+dvl+pressure": (("dvl", "pressure"), True, *base, [t(z.T), t(mu[:, 3:].T + 0.1)], [r3, r1],
                                     [7.815, -1.0]),
        }
        for case, args in cases.items():
            cov_out, mu_out, trk_out, infos = vf.velocity_step_lanes_cuda(*args)
            h = hashlib.sha256()
            for x in (cov_out, mu_out, trk_out, *(v for info in infos for v in info)):
                h.update(x.detach().cpu().numpy().tobytes())
            out[f"velocity_step[{case}],{str(dtype).split('.')[-1]}"] = h.hexdigest()[:16]
    return out


# velocity_digests of the build before the move (NVIDIA H100 80GB HBM3, CUDA
# 12.8, PyTorch 2.11); a change of K6's arithmetic, or of the compiler,
# changes them
VELOCITY_DIGESTS = {
    "velocity_step[predict],float32": "308a5bb60326b615",
    "velocity_step[predict],float64": "b22658ea1382e0c7",
    "velocity_step[predict+dvl+pressure],float32": "6858413ce80bbd95",
    "velocity_step[predict+dvl+pressure],float64": "cae258c7d0c784f3",
    "velocity_step[update],float32": "fb8a8ab4d601b6f0",
    "velocity_step[update],float64": "25ddfbb10dde0dea",
}


def test_k6_bit_identical_to_before_the_shared_header(device):
    got = velocity_digests(device)
    assert VELOCITY_DIGESTS, "no recorded digests"
    differ = {k: (got[k], v) for k, v in VELOCITY_DIGESTS.items() if got.get(k) != v}
    assert not differ, differ


# ---------------------------------------------------------------------------
# K7 (the whole BottomUKF step) and K8 (the banked SPD solve)
# ---------------------------------------------------------------------------


def _unit(v):
    v = np.asarray(v, dtype=np.float64)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def bottom_operands(device, dtype, nb=NB, seed=14):
    """K7 operands on a bank of BottomUKF filters: correlated covariances,
    velocities, normals tilted at random, at the pole's neighbourhood and on
    both sides of the equator (x₂ = ±1e-3, where the basis changes sides;
    float32 rounding of a mean at ±1e-9 would pick the side itself), three
    pad lanes at the end in the JAX package's convention; a range whose
    instance 4 is a wild outlier for a χ² gate, a normal observation.
    Returns {case: args} for predict, range, normal and the chain."""
    from slam_uwv_kalman_filters_tpu_torch.models import bottom_fused as bf

    rng = np.random.default_rng(seed)
    normals = _unit(rng.normal(size=(nb, 3)) * 0.2 + [0.0, 0.0, 1.0])
    normals[0], normals[1] = _unit([1e-3, -2e-3, 1.0]), _unit([0.3, 0.2, 1e-3])
    normals[2], normals[3] = _unit([0.3, -0.2, -1e-3]), _unit([0.0, 0.1, -1.0])
    g = rng.normal(size=(nb, 3, 3)) * 0.1
    cov = g @ np.swapaxes(g, 1, 2) + np.diag([0.5, 0.02, 0.02])
    dist = 12.0 + rng.normal(size=(nb, 1))
    vel = rng.normal(0.0, 0.5, (nb, 3))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)
    pad, lanes = 3, nb + 3
    ls = bf.BottomLanesState(
        cov_t=t(np.transpose(np.concatenate([cov, np.broadcast_to(np.eye(3), (pad, 3, 3))]), (2, 1, 0))),
        mu_t=t(np.concatenate([np.concatenate([dist, normals], 1), np.tile(np.concatenate([dist[:1], normals[:1]], 1),
                                                                           (pad, 1))]).T),
        vel_t=t(np.concatenate([vel, np.tile(vel[:1], (pad, 1))]).T),
    )
    beam = _unit(rng.normal(size=(lanes, 3)) * [0.2, 0.2, 0.1] + [0.0, 0.0, -1.0])
    beam[nb:] = [0.0, 0.0, -1.0]
    org = rng.normal(0.0, 0.1, (lanes, 3))
    org[nb:] = 0.0
    # ranges near the ones the means predict: h = ((0, 0, −d) − o)·n / (dir·n)
    z = (np.einsum("bi,bi->b", np.concatenate([np.zeros((nb, 2)), -dist], 1) - org[:nb], normals)
         / np.einsum("bi,bi->b", beam[:nb], normals) + rng.normal(0.0, 0.05, nb))
    z = np.concatenate([z, np.zeros(pad)])[None]
    z[0, 4] += 500.0
    zn = _unit(np.concatenate([normals, np.tile([0.0, 0.0, 1.0], (pad, 1))]) + rng.normal(0.0, 0.05, (lanes, 3)))
    r1 = (torch.eye(1, dtype=dtype, device=device) * 0.04)[..., None].expand(1, 1, lanes).contiguous()
    r2 = (torch.eye(2, dtype=dtype, device=device) * 0.01)[..., None].expand(2, 2, lanes).contiguous()
    qa = rng.normal(size=(3, 3)) * 0.3
    q9 = tuple((qa @ qa.T + np.eye(3)).reshape(9).tolist())
    base = (ls.cov_t, ls.mu_t, ls.vel_t, 0.1, q9)
    rng_ops = ([t(z)], [r1], [t(beam.T)], [t(org.T)], [3.841])
    nrm_ops = ([t(zn.T)], [r2], [None], [None], [5.991])
    return {
        "predict": ((), True, *base, [], [], [], [], []),
        "range": (("range",), False, *base, *rng_ops),
        "normal": (("normal",), False, *base, *nrm_ops),
        "predict+range+normal": (("range", "normal"), True, *base,
                                 *(a + b for a, b in zip(rng_ops, nrm_ops))),
    }


@pytest.mark.parametrize("case", ["predict", "range", "normal", "predict+range+normal"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bottom_step_kernel_matches_plain(device, dtype, case):
    from slam_uwv_kalman_filters_tpu_torch.models import bottom_fused as bf

    args = bottom_operands(device, dtype)[case]
    ko, po = bf.bottom_step_lanes_cuda(*args), bf.bottom_step_lanes_plain(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(ko[0]).all()) and bool(torch.isfinite(ko[1]).all())  # pad lanes included
    assert max(_rel(ko[0], po[0]), _rel(ko[1], po[1])) <= LIMIT[dtype]
    for (km2, kacc, knu), (pm2, pacc, pnu) in zip(ko[2], po[2]):
        assert torch.equal(kacc, pacc)
        assert max(_rel(km2, pm2), _rel(knu, pnu)) <= LIMIT[dtype]
    if "range" in case:  # instance 4 rejected, keeping its prior exactly
        acc = ko[2][0][1][0, :NB]
        assert acc[4] == 0.0 and int(acc.sum()) == NB - 1
        if case == "range":
            assert torch.equal(ko[0][..., 4], args[2][..., 4]) and torch.equal(ko[1][:, 4], args[3][:, 4])


def spd_operands(device, dtype, k, ill, nb=300, seed=15):
    """(n, n, nb) SPD systems in the lanes layout (NaN in the unread half)
    and (n, k, nb) right-hand sides, n = 53: random correlated systems with
    variances from 1e-11 to 10, or the ill-conditioned case of the JAX
    package's smoother test (base = aaᵀ + 53·I scaled by 10^U(-5.5, 0.5))."""
    rng = np.random.default_rng(seed)
    n = 53
    if ill:
        a = rng.normal(size=(nb, n, n))
        base = a @ np.swapaxes(a, 1, 2) + n * np.eye(n)
        d = 10.0 ** rng.uniform(-5.5, 0.5, n)
    else:
        g = rng.normal(size=(nb, n, n))
        base = g @ np.swapaxes(g, 1, 2) / n + np.eye(n)
        s = np.sqrt(np.diagonal(base, axis1=1, axis2=2))
        base = base / (s[:, :, None] * s[:, None, :])
        d = np.sqrt(10.0 ** rng.uniform(-11.0, 1.0, n))
    spd = base * d[None, :, None] * d[None, None, :]
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=device).to(dtype)
    a_t = t(np.transpose(spd, (2, 1, 0)))
    lower = torch.tril(torch.ones(n, n, dtype=torch.bool, device=device), -1)[..., None]
    return torch.where(lower, float("nan"), a_t).contiguous(), t(np.transpose(rng.normal(size=(nb, n, k)), (1, 2, 0)))


def _solve_err(x, ref, a_t):
    """Max error of D·x over the largest |D·x| of its column and instance,
    D = √diag A: the equilibrated solve's accuracy is relative in D·x."""
    d = torch.sqrt(torch.diagonal(a_t, dim1=0, dim2=1).T)[:, None, :]
    scale = (ref * d).abs().amax(dim=0, keepdim=True)
    return ((x - ref).abs() * d / scale).max().item()


@pytest.mark.parametrize("k,ill", [(1, False), (53, False), (53, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_solve_spd_kernel_matches_plain(device, dtype, k, ill):
    a_t, b_t = spd_operands(device, dtype, k, ill)
    ko, po = kernels.solve_spd_lanes_cuda(a_t, b_t), kernels.solve_spd_lanes_plain(a_t, b_t)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(ko).all())
    assert _solve_err(ko, po, a_t) <= LIMIT[dtype]


def test_bottom_and_solve_wrappers_launch_and_count(device):
    from slam_uwv_kalman_filters_tpu_torch.models import bottom_fused as bf
    from slam_uwv_kalman_filters_tpu_torch.models import bottom_ukf as bu

    dtype = torch.float32
    st, params = bu.init(bu.BottomState(torch.tensor([10.0], device=device), torch.tensor([0.0, 0.0, 1.0], device=device)),
                         torch.diag(torch.tensor([1.0, 0.05, 0.05], device=device)))
    bs = bank.replicate(bu.set_velocity(st, torch.tensor([0.5, 0.0, -0.1], device=device)), NB)
    k7, k8 = puf.cuda_lib.KERNELS["bottom_step"], puf.cuda_lib.KERNELS["solve_spd"]
    before7, before8 = k7.launches, k8.launches
    out = bu.predict_bank(bs, params, 0.1)
    out, info = bu.update_range_bank(out, torch.full((NB, 1), 9.8, device=device), torch.eye(1, device=device) * 0.04,
                                     torch.tensor([0.0, 0.0, -1.0], device=device), torch.zeros(3, device=device))
    a_t, b_t = spd_operands(device, dtype, 4, False, nb=NB)
    spd = torch.where(torch.isnan(a_t), a_t.transpose(0, 1), a_t).permute(2, 1, 0)
    x = kernels.solve_spd_banked(spd, b_t.permute(2, 0, 1))
    torch.cuda.synchronize()
    assert (k7.launches, k8.launches) == (before7 + 2, before8 + 1)
    assert bool(torch.isfinite(out.cov).all()) and bool(info.accepted.all())
    assert bool(torch.isfinite(x).all())
    too_many = [bf.StepUpdate("normal", out.mu.normal, torch.eye(2, device=device))] * (bf.MAX_STEP_UPDATES + 1)
    with pytest.raises(ValueError, match="MAX_STEP_UPDATES"):
        bf.step_lanes(bf.to_lanes(out), params, 0.1, too_many)


# ---------------------------------------------------------------------------
# K9 (the IndirectPoseUKF predict) and K10 (its marker update)
# ---------------------------------------------------------------------------


def indirect_operands(device, dtype, nb=300, k=4, per_instance=False, lanes=None, seed=21):
    """A bank of IndirectPoseUKF filters (moved error means, orientation
    errors up to ~0.3 rad, random correlated covariances, pose references)
    with a shared process noise, and k marker corners seen from ref ∘ a true
    bias with 1 px of noise: shared pixels and marker pose, or per instance.
    ``lanes`` > nb pads. Returns (K9 args, K10 args)."""
    from slam_uwv_kalman_filters_tpu_torch.models import indirect_fused as ifu
    from slam_uwv_kalman_filters_tpu_torch.models import indirect_pose_ukf as ipu
    from slam_uwv_kalman_filters_tpu_torch.ops import manifolds as mf
    from slam_uwv_kalman_filters_tpu_torch.utils.config import CameraConfiguration

    f64 = torch.float64
    gen = torch.Generator(device=device).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=gen, dtype=f64, device=device)
    t = lambda v: torch.tensor(v, dtype=f64, device=device)
    a = rn(nb, 6, 6) * 0.1
    state = ipu.IndirectPoseUKFState(
        mu=ipu.PoseErrorState(rn(nb, 3) * 0.2, mf.quat_exp(rn(nb, 3) * 0.15)),
        cov=a @ a.transpose(1, 2) + torch.diag(t([0.05, 0.04, 0.06, 0.003, 0.002, 0.004])),
        pose_ref_position=rn(nb, 3) * 0.5, pose_ref_orientation=mf.quat_exp(rn(nb, 3) * 0.1))
    _, params = ipu.init((0.05,) * 3, (0.02,) * 3, 30.0, device=device)
    qa = rn(6, 6) * 0.01
    params = params._replace(process_noise=params.process_noise + qa @ qa.T)
    corners = t([[-0.15, -0.15, 0.0], [0.15, -0.15, 0.0], [0.15, 0.15, 0.0], [-0.15, 0.15, 0.0]])[:k]
    mpos, mrot = t([0.3, -0.2, 3.0]), mf.quat_exp(t([0.02, -0.05, 0.1]))
    if per_instance:
        mpos, mrot = mpos + rn(nb, 3) * 0.05, mf.so3_boxplus(mrot.expand(nb, 4), rn(nb, 3) * 0.02)
    cam_p, cam_q, cam = t([0.1, 0.0, 0.05]), mf.quat_exp(t([0.01, -0.02, 0.03])), CameraConfiguration()
    # the pixels of the corners from the true camera pose ref ∘ bias ∘ extrinsics
    body = mf.affine_mul(state.pose_ref_orientation, state.pose_ref_position + t([0.1, -0.05, 0.08]),
                         cam_q, cam_p)
    qi, pi = mf.affine_inv(*body)
    f_nav = mf.affine_apply(mrot[..., None, :], mpos[..., None, :], corners)
    f_cam = mf.affine_apply(qi[:, None], pi[:, None], f_nav)
    px = torch.stack([cam.fx * f_cam[..., 0] / f_cam[..., 2] + cam.cx, cam.fy * f_cam[..., 1] / f_cam[..., 2] + cam.cy],
                     -1) + rn(nb, k, 2)
    feats = px if per_instance else px[0]
    to = lambda tree: bank.tree_map(lambda x: x.to(dtype), tree)
    ls = ifu.to_lanes(to(state), lanes=lanes)
    _, ops = ifu.marker_operands(ls, feats, torch.eye(2, dtype=f64, device=device) * 4.0, corners, mpos, mrot,
                                 torch.eye(6, dtype=f64, device=device) * 1e-3, cam, cam_p, cam_q, nb=nb)
    return (ls.cov_t, ls.mu_t, ifu.predict_scalars(to(params), 0.1, dtype)), ops


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_indirect_predict_kernel_matches_plain(device, dtype):
    from slam_uwv_kalman_filters_tpu_torch.models import indirect_fused as ifu

    args, _ = indirect_operands(device, dtype)
    ko, po = ifu.indirect_predict_lanes_cuda(*args), ifu.indirect_predict_lanes_plain(*args)
    torch.cuda.synchronize()
    assert _cov_err(ko[0], po[0], po[0]) <= LIMIT[dtype]
    assert _rel(ko[1], po[1]) <= LIMIT[dtype]


@pytest.mark.parametrize("k,per_instance", [(1, False), (4, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_indirect_markers_kernel_matches_plain(device, dtype, k, per_instance):
    from slam_uwv_kalman_filters_tpu_torch.models import indirect_fused as ifu

    _, args = indirect_operands(device, dtype, k=k, per_instance=per_instance)
    ko, po = ifu.indirect_markers_lanes_cuda(*args), ifu.indirect_markers_lanes_plain(*args)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x).all()) for x in ko)
    assert _cov_err(ko[0], po[0], args[0]) <= LIMIT[dtype]  # normalized by the prior
    assert max(_rel(ko[i], po[i]) for i in (1, 2, 3)) <= LIMIT[dtype]


def test_indirect_wrappers_launch_and_count(device):
    """predict_bank and update_markers_bank on a CUDA bank launch K9 and K10
    once each; a banked τ sweep takes the generic path (no K9)."""
    from slam_uwv_kalman_filters_tpu_torch.models import indirect_pose_ukf as ipu
    from slam_uwv_kalman_filters_tpu_torch.utils.config import CameraConfiguration

    state, params = ipu.init((0.05,) * 3, (0.02,) * 3, 30.0, dtype=torch.float32, device=device)
    bs = bank.replicate(state, NB)
    k9, k10 = puf.cuda_lib.KERNELS["indirect_predict"], puf.cuda_lib.KERNELS["indirect_markers"]
    before9, before10 = k9.launches, k10.launches
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    out = ipu.predict_bank(bs, params, 0.1)
    out, info = ipu.update_markers_bank(out, t([[330.0, 236.0]]), torch.eye(2, device=device)[None] * 4.0,
                                        t([[0.1, 0.1, 0.0]]), t([2.0, 0.0, 1.0]), t([1.0, 0.0, 0.0, 0.0]),
                                        torch.eye(6, device=device) * 1e-4, CameraConfiguration(),
                                        torch.zeros(3, device=device), t([1.0, 0.0, 0.0, 0.0]))
    torch.cuda.synchronize()
    assert (k9.launches, k10.launches) == (before9 + 1, before10 + 1)
    assert info.mahalanobis2.shape == (NB, 1) and bool(torch.isfinite(out.cov).all())
    ipu.predict_bank(bs, params._replace(orientation_error_tau=torch.full((NB,), 30.0, device=device)), 0.1)
    torch.cuda.synchronize()
    assert k9.launches == before9 + 1


def small_digests(device, outputs: dict | None = None) -> dict:
    """sha256 (first 16 hex digits) of K7's outputs — covariance, mean, NIS,
    gate, innovation — for the four cases of :func:`bottom_operands`, K9's on
    :func:`indirect_operands` and K10's with 1 and 4 corners, shared and
    per-instance marker data, at bank ``NB``, float32 and float64. The
    operands are made on the CPU (a float64 matrix product on the card
    rounds differently from call to call) and moved to the card.
    ``outputs``, when given, also receives each key's output tensors on the
    CPU. It calls only the wrappers' signatures, so it hashes an earlier
    build of the package as well."""
    from slam_uwv_kalman_filters_tpu_torch.models import bottom_fused as bf
    from slam_uwv_kalman_filters_tpu_torch.models import indirect_fused as ifu

    out = {}

    def record(key, tensors):
        h = hashlib.sha256()
        kept = [x.detach().cpu() for x in tensors]
        for x in kept:
            h.update(x.numpy().tobytes())
        out[key] = h.hexdigest()[:16]
        if outputs is not None:
            outputs[key] = kept

    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        for case, args in bottom_operands(device, dtype).items():
            cov, mu, infos = bf.bottom_step_lanes_cuda(*args)
            record(f"bottom_step[{case}],{name}", [cov, mu, *(x for info in infos for x in info)])
        for k, per_instance in ((1, False), (1, True), (4, False), (4, True)):
            k9, k10 = (tuple(x.to(device) for x in args)
                       for args in indirect_operands("cpu", dtype, nb=NB, k=k, per_instance=per_instance))
            if (k, per_instance) == (1, False):
                record(f"indirect_predict,{name}", ifu.indirect_predict_lanes_cuda(*k9))
            form = "per-instance" if per_instance else "shared"
            record(f"indirect_markers[k={k},{form}],{name}", ifu.indirect_markers_lanes_cuda(*k10))
    return out


# small_digests of the build before K7 and K10 moved to a group of lanes per
# instance (the one-thread kernels; NVIDIA H100 80GB HBM3, 700 W, nvcc 12.9,
# PyTorch 2.11 with CUDA 12.8); K9 is not redesigned there and is held to its
# bits too
SMALL_DIGESTS = {
    "bottom_step[normal],float32": "8a0afe5ff94e72bd",
    "bottom_step[normal],float64": "5950196a60fb5998",
    "bottom_step[predict+range+normal],float32": "03f4b5e9f60de8a0",
    "bottom_step[predict+range+normal],float64": "b7f041fb4d2e3f3c",
    "bottom_step[predict],float32": "65aaec6d2f762819",
    "bottom_step[predict],float64": "0d827def054bedf3",
    "bottom_step[range],float32": "a1aaaaa82be76ecd",
    "bottom_step[range],float64": "b83e72c833c1dd3a",
    "indirect_markers[k=1,per-instance],float32": "368f27513e125f11",
    "indirect_markers[k=1,per-instance],float64": "2f1f75afd6cd37c6",
    "indirect_markers[k=1,shared],float32": "01e6964792d59b1d",
    "indirect_markers[k=1,shared],float64": "1429c1df3e76578a",
    "indirect_markers[k=4,per-instance],float32": "80aad9cf337e7990",
    "indirect_markers[k=4,per-instance],float64": "35cd821299332085",
    "indirect_markers[k=4,shared],float32": "12c805e4bfa49a0e",
    "indirect_markers[k=4,shared],float64": "1ec028b2803e2398",
    "indirect_predict,float32": "56ea0b5421f7da91",
    "indirect_predict,float64": "7744054a0e8025b9",
}


def test_k7_k9_k10_bit_identical_to_the_one_thread_kernels(device):
    got = small_digests(device)
    differ = {k: (got[k], v) for k, v in SMALL_DIGESTS.items() if got.get(k) != v}
    assert not differ, differ


# ---------------------------------------------------------------------------
# K11 (the PoseUKF visual-marker update with the 59-DOF augmentation)
# ---------------------------------------------------------------------------

MARKER_CORNERS = ((0.15, 0.15, 0.0), (-0.15, 0.15, 0.0), (-0.15, -0.15, 0.0), (0.15, -0.15, 0.0))
MARKER_CAM_Q = (0.5, -0.5, 0.5, -0.5)  # the optical axis along body +x


def marker_bank(device, dtype, nb=300, k=4, per_instance=False, seed=23):
    """A bank of PoseUKF mission states (positions moved by 0.3 m,
    orientations by ~0.05 rad, random correlated covariances at half the
    initial per-field scales) and k corners of a marker 6 m ahead, projected
    from each instance's own pose with 1 px of noise (bearings near the
    camera's axis, far from the S² equator). Returns (bank state, the
    marker arguments of ``update_visual_features_bank`` after the state and
    parameters)."""
    from slam_uwv_kalman_filters_tpu_torch.ops import manifolds as mf
    from slam_uwv_kalman_filters_tpu_torch.utils.config import CameraConfiguration

    f64 = torch.float64
    gen = torch.Generator(device=device).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=gen, dtype=f64, device=device)
    t = lambda v: torch.tensor(v, dtype=f64, device=device)
    state, _ = pukf.init_from_pose(t([0.0] * 3), torch.eye(3, dtype=f64) * 0.01, t([1.0, 0.0, 0.0, 0.0]),
                                   torch.eye(3, dtype=f64) * 1e-4, default_pose_ukf_config(),
                                   dyn.default_uwv_parameters(device=device), device=device)
    bs = bank.replicate(state, nb)
    g = rn(nb, 53, 53)
    c = g @ g.transpose(1, 2) / 53 + torch.eye(53, dtype=f64, device=device)
    s = torch.sqrt(torch.diagonal(c, dim1=1, dim2=2))
    sd = 0.5 * torch.sqrt(torch.diagonal(state.cov))
    bs = bs._replace(
        mu=bs.mu._replace(position=0.3 * rn(nb, 3), orientation=mf.so3_boxplus(bs.mu.orientation, 0.05 * rn(nb, 3)),
                          velocity=0.2 * rn(nb, 3)),
        cov=c / (s[:, :, None] * s[:, None, :]) * sd[None, :, None] * sd[None, None, :])
    corners = t(MARKER_CORNERS[:k])
    mpos, mrot = t([6.0, 0.0, 0.0]), t(MARKER_CAM_Q)
    if per_instance:
        mpos, mrot = mpos + 0.05 * rn(nb, 3), mf.so3_boxplus(mrot.expand(nb, 4), 0.02 * rn(nb, 3))
    cam, cam_p, cam_q = CameraConfiguration(), t([0.1, -0.05, 0.02]), t(MARKER_CAM_Q)
    qi, pi = mf.affine_inv(*mf.affine_mul(bs.mu.orientation, bs.mu.position, cam_q, cam_p))
    f_cam = mf.affine_apply(qi[:, None], pi[:, None], mf.affine_apply(mrot[..., None, :], mpos[..., None, :], corners))
    px = torch.stack([cam.fx * f_cam[..., 0] / f_cam[..., 2] + cam.cx, cam.fy * f_cam[..., 1] / f_cam[..., 2] + cam.cy],
                     -1) + rn(nb, k, 2)
    args = (px if per_instance else px[0], torch.eye(2, dtype=f64, device=device) * 4.0, corners, mpos, mrot,
            torch.eye(6, dtype=f64, device=device) * 1e-3, cam, cam_p, cam_q)
    return bank.tree_map(lambda x: x.to(dtype), bs), args


def marker_operands(device, dtype, nb=300, k=4, per_instance=False, lanes=None):
    """K11's operands for :func:`marker_bank`; ``lanes`` > nb pads the bank
    in the JAX package's convention (identity covariances, copies of
    instance 0)."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_marker_fused as pmf

    bs, args = marker_bank(device, dtype, nb, k, per_instance)
    ls = pf.to_lanes(bs)
    if lanes is not None:
        pad = lanes - nb
        eye = torch.eye(53, dtype=dtype, device=device)[..., None].expand(53, 53, pad)
        ls = ls._replace(cov_t=torch.cat([ls.cov_t, eye], -1).contiguous(),
                         mu_t=torch.cat([ls.mu_t, ls.mu_t[:, :1].expand(54, pad)], -1).contiguous())
    return pmf.marker_operands(ls, *args, nb=nb)[1]


@pytest.mark.parametrize("k,per_instance", [(1, False), (1, True), (4, False), (4, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pose_markers_kernel_matches_plain(device, dtype, k, per_instance):
    from slam_uwv_kalman_filters_tpu_torch.models import pose_marker_fused as pmf

    args = marker_operands(device, dtype, k=k, per_instance=per_instance)
    ko, po = pmf.pose_markers_lanes_cuda(*args), pmf.pose_markers_lanes_plain(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(pf._mirror_half(ko[0])).all()) and all(bool(torch.isfinite(x).all()) for x in ko[1:])
    assert _cov_err(ko[0], po[0], args[0]) <= LIMIT[dtype]  # normalized by the prior
    assert max(_rel(ko[i], po[i]) for i in (1, 2, 3)) <= LIMIT[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pose_markers_pad_lanes_leave_the_bank_alone(device, dtype):
    """28 pad lanes (identity covariance, pad corners: bearing (0, 0, 1),
    R = I, an identity marker pose) leave the bank's outputs bit-identical
    and stay finite."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_marker_fused as pmf

    plain_bank = pmf.pose_markers_lanes_cuda(*marker_operands(device, dtype, per_instance=True))
    padded = pmf.pose_markers_lanes_cuda(*marker_operands(device, dtype, per_instance=True, lanes=328))
    torch.cuda.synchronize()
    valid = torch.triu(torch.ones(53, 53, dtype=torch.bool, device=device))
    assert torch.equal(plain_bank[0][valid], padded[0][..., :300][valid])
    assert all(torch.equal(a, b[..., :300]) for a, b in zip(plain_bank[1:], padded[1:]))
    assert bool(torch.isfinite(padded[0][..., 300:][valid]).all())
    assert all(bool(torch.isfinite(b[..., 300:]).all()) for b in padded[1:])


def test_pose_markers_bank_update_launches_and_counts(device, monkeypatch):
    """update_visual_features_bank on a CUDA bank launches K11 once, and its
    result is the plain version's on the same bank."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_marker_fused as pmf

    bs, args = marker_bank(device, torch.float32, nb=NB, k=4, per_instance=True)
    k11 = puf.cuda_lib.KERNELS["pose_markers"]
    before = k11.launches
    out, info = pukf.update_visual_features_bank(bs, None, *args)
    torch.cuda.synchronize()
    assert k11.launches == before + 1
    assert info.mahalanobis2.shape == (NB, 4) and bool(info.accepted.all())
    monkeypatch.setattr(pmf, "_pose_markers_lanes", pmf.pose_markers_lanes_plain)
    ref, ref_info = pukf.update_visual_features_bank(bs, None, *args)
    assert k11.launches == before + 1
    assert _cov_err(pf.to_lanes(out).cov_t, pf.to_lanes(ref).cov_t, pf.to_lanes(bs).cov_t) <= LIMIT[torch.float32]
    assert _rel(pf._pack_storage(out.mu), pf._pack_storage(ref.mu)) <= LIMIT[torch.float32]
    assert _rel(info.mahalanobis2, ref_info.mahalanobis2) <= LIMIT[torch.float32]


# ---------------------------------------------------------------------------
# K12 (the banked Cholesky) and K13 (the FMA roofline probe)
# ---------------------------------------------------------------------------


def chol_operands(device, dtype, n, nb=NB, seed=33):
    """(n, n, nb) SPD matrices in the lanes layout with the 53-DOF
    covariance's spread (variances 1e-11 … 10, random correlations), NaN in
    the unread upper half."""
    rng = np.random.default_rng(seed + n)
    g = rng.normal(size=(nb, n, n))
    base = g @ np.swapaxes(g, 1, 2) / n + np.eye(n)
    s = np.sqrt(np.diagonal(base, axis1=1, axis2=2))
    d = np.sqrt(10.0 ** rng.uniform(-11.0, 1.0, n))
    spd = base / (s[:, :, None] * s[:, None, :]) * d[None, :, None] * d[None, None, :]
    a_t = torch.as_tensor(np.ascontiguousarray(np.transpose(spd, (2, 1, 0))), device=device).to(dtype)
    lower = torch.tril(torch.ones(n, n, dtype=torch.bool, device=device), -1)[..., None]
    return torch.where(lower, float("nan"), a_t).contiguous()


def _chol_err(out_t, ref_t, a_t):
    """Max |ΔL(r, c)| / √A_rr: row r of the factor scales with √A_rr."""
    d = torch.sqrt(torch.diagonal(a_t, dim1=0, dim2=1).T)  # (n, nb), indexed [r, b]
    return ((out_t - ref_t).abs() / d[None, :, :]).max().item()


@pytest.mark.parametrize("n", [9, 53, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cholesky_kernel_matches_plain(device, dtype, n):
    a_t = chol_operands(device, dtype, n)
    ko, po = kernels.cholesky_lanes_cuda(a_t), kernels.cholesky_lanes_plain(a_t)
    torch.cuda.synchronize()
    upper = torch.tril(torch.ones(n, n, dtype=torch.bool, device=device), -1)  # [c, r < c]
    assert bool((ko[upper] == 0).all()) and bool(torch.isfinite(ko).all())
    assert _chol_err(ko, po, a_t) <= LIMIT[dtype]


def test_cholesky_banked_routes_through_k12_and_refuses_what_it_cannot_factor(device):
    k12 = puf.cuda_lib.KERNELS["cholesky"]
    a_t = chol_operands(device, torch.float64, 53)
    cov = torch.where(torch.isnan(a_t), a_t.transpose(0, 1), a_t).permute(2, 1, 0).contiguous()
    cov[4, 10, 10] = -1.0  # not SPD: both versions give NaN for that matrix
    before = k12.launches
    out = kernels.cholesky_banked(cov)
    one = kernels.cholesky_fast(cov[0])
    torch.cuda.synchronize()
    assert k12.launches == before + 2
    ref = kernels.cholesky_plain(cov)
    assert bool(torch.isnan(out[4]).all()) and bool(torch.isnan(ref[4]).all())
    keep = torch.arange(NB, device=device) != 4
    assert _chol_err(out.permute(2, 1, 0)[..., keep], ref.permute(2, 1, 0)[..., keep], a_t[..., keep]) <= 1e-9
    assert torch.equal(one, out[0])
    assert torch.equal(kernels.cholesky_banked(cov[:, :6, :6]), kernels.cholesky_plain(cov[:, :6, :6]))  # unrolled
    assert k12.launches == before + 2
    with pytest.raises(ValueError, match="n <= 64"):
        kernels.cholesky_banked(torch.eye(65, dtype=torch.float64, device=device).expand(3, 65, 65))


def test_fma_probe_kernel_matches_plain_and_measures(device):
    from slam_uwv_kalman_filters_tpu_torch.tools import roofline

    gen = torch.Generator(device=device).manual_seed(5)
    a = 0.75 + 0.5 * torch.rand(1 << 20, generator=gen, device=device)
    b = 0.9 + 0.1 * torch.rand(1 << 20, generator=gen, device=device)
    k13 = puf.cuda_lib.KERNELS["fma_probe"]
    before = k13.launches
    ko, po = roofline.fma_probe_cuda(a, b), roofline.fma_probe_plain(a, b)
    torch.cuda.synchronize()
    assert k13.launches == before + 1
    assert ((ko - po).abs().max() / po.abs().max()).item() <= 1e-5
    assert roofline.measure_fma(launches=4, elements=1 << 22) > 1e12
    assert k13.launches == before + 1 + 5  # one warm launch and four timed
    assert roofline.measure_hbm(iters=4, elements=1 << 26) > 1e11
    with pytest.raises(TypeError):
        roofline.fma_probe_cuda(a.double(), b.double())


# ---------------------------------------------------------------------------
# the vmap rules of K1, K8 and K12: a vmapped call is one banked launch
# ---------------------------------------------------------------------------


def _launches():
    return {k: v.launches for k, v in puf.cuda_lib.KERNELS.items()}


def _one_more(before, name):
    return {k: v + (k == name) for k, v in before.items()}


@pytest.mark.parametrize("layout", ["flat", "nested"])
@pytest.mark.parametrize("name", ["sigma_deltas", "cholesky"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_factor_vmap_rule_is_one_banked_launch(device, dtype, name, layout):
    """``torch.func.vmap`` of ``sigma_deltas_fast`` / ``cholesky_fast`` on
    one 53×53 matrix an instance (a bank-first strided view, and a vmap of a
    vmap over a (10, 13) grid): one launch of the kernel and none other, and
    the bits of one banked call on the same stack."""
    fast, banked = {"sigma_deltas": (kernels.sigma_deltas_fast, kernels.sigma_deltas_banked),
                    "cholesky": (kernels.cholesky_fast, kernels.cholesky_banked)}[name]
    cov = chol_operands(device, dtype, 53).permute(2, 1, 0)  # (NB, n, n), lower half valid
    ref = banked(cov)
    torch.cuda.synchronize()
    before = _launches()
    if layout == "flat":
        out = torch.func.vmap(fast)(cov)
    else:
        out = torch.func.vmap(torch.func.vmap(fast))(cov.reshape(10, 13, 53, 53)).reshape(ref.shape)
    torch.cuda.synchronize()
    assert _launches() == _one_more(before, name)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("rhs", ["batched", "shared"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_solve_spd_vmap_rule_is_one_banked_launch(device, dtype, rhs):
    """``torch.func.vmap`` of ``solve_spd_fast`` on one 53×53 system with 53
    right-hand sides an instance, the right-hand sides batched or shared
    (expanded without a copy): one K8 launch, the bits of one banked
    solve."""
    a_t, b_t = spd_operands(device, dtype, 53, False, nb=NB)
    spd, b = a_t.permute(2, 1, 0), b_t.permute(2, 0, 1)
    if rhs == "shared":
        b = b[0]
        ref = kernels.solve_spd_banked(spd, b.expand(NB, 53, 53))
        vmapped = torch.func.vmap(kernels.solve_spd_fast, in_dims=(0, None))
    else:
        ref = kernels.solve_spd_banked(spd, b)
        vmapped = torch.func.vmap(kernels.solve_spd_fast)
    torch.cuda.synchronize()
    before = _launches()
    out = vmapped(spd, b)
    torch.cuda.synchronize()
    assert _launches() == _one_more(before, "solve_spd")
    assert torch.equal(out, ref)


def test_lanes_vmap_rule_and_solo_predict_launch_once(device):
    """The lanes K1 op folds a vmapped axis next to its lane axis (one
    launch, the bits of the folded call); ``vmap_filter(pose_ukf.predict)``
    over a bank is one K1 launch a call, and an op with no rule raises under
    vmap."""
    from slam_uwv_kalman_filters_tpu_torch.models import indirect_fused as ifu

    a_t = chol_operands(device, torch.float32, 53, nb=2 * NB).reshape(53, 53, 2, NB).movedim(2, 0)
    ref = kernels.sigma_deltas_lanes(a_t.movedim(0, 2).reshape(53, 53, 2 * NB))
    torch.cuda.synchronize()
    before = _launches()
    out = torch.func.vmap(kernels.sigma_deltas_lanes)(a_t)
    torch.cuda.synchronize()
    assert _launches() == _one_more(before, "sigma_deltas")
    assert torch.equal(out.movedim(0, 2).reshape(ref.shape), ref)
    bs, params = _bank(device, torch.float32)
    before = _launches()
    pred = bank.vmap_filter(pukf.predict, data_axes=None)(bs, params, 0.01)
    torch.cuda.synchronize()
    assert _launches() == _one_more(before, "sigma_deltas")
    assert bool(torch.isfinite(pred.cov).all())
    with pytest.raises(NotImplementedError, match="slam_uwv::indirect_predict"):
        torch.func.vmap(lambda c: ifu._indirect_predict_lanes(c, c[0], c[0, 0]))(
            torch.zeros(2, 6, 6, 4, device=device))

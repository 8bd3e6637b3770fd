"""K1 (sigma deltas), K8 (SPD solve) and K12 (the banked Cholesky), the
warp-per-matrix kernels of ``csrc/sigma_deltas.cu``, ``csrc/solve_spd.cu``
and ``csrc/cholesky.cu``, against their plain PyTorch versions.

The tests marked ``cuda`` run the kernels on the card and skip without one
(a CUDA kernel has no CPU mode): every n from 1 to the 64 the core takes
(across the 32-row boundary of a lane's two rows), banks of 1, 7 and 300,
the lanes layout, the bank-first layout and strided views of both (the
smoother hands K8 a transposed right-hand side), float32 and float64, and
for K8 1, 53 and 70 right-hand sides (70: two chunks of the lanes' columns).
Limits are the other card tests': float64 1e-9, float32 2e-3 of the
normalized error (a 64-column factorization rounded in another order than
the library's; K12's error is |ΔL(r, c)| over √A_rr). A matrix that is not
SPD comes back NaN (K1: its ± rows; K8: its solution; K12: its factor) and
leaves its neighbours as the plain version has them.

The other tests run on the CPU: each wrapper hands its kernel the input's
own memory and the strides of its (bank, row, col) axes, allocates only the
output, and a stand-in for the kernel that reads and writes exactly what
those pointers and strides describe gives the plain version's result. This
file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_warp_kernels.py
"""

import ctypes

import numpy as np
import pytest
import torch

from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib, kernels

LIMIT = {torch.float32: 2e-3, torch.float64: 1e-9}
SIZES = [1, 31, 32, 33, 53, 55, 59, 64]
LAYOUTS = ["lanes", "bank-first", "views"]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def spd_bank(nb, n, seed, dtype, device):
    """(nb, n, n) SPD matrices [b, row, col] with the 53-DOF covariance's
    spread (variances 1e-11 … 10, random correlations), NaN above the
    diagonal, which no version reads."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(nb, n, n))
    base = g @ np.swapaxes(g, 1, 2) / n + np.eye(n)
    s = np.sqrt(np.diagonal(base, axis1=1, axis2=2))
    d = np.sqrt(10.0 ** rng.uniform(-11.0, 1.0, n))
    a = torch.as_tensor(base / (s[:, :, None] * s[:, None, :]) * d[None, :, None] * d[None, None, :])
    upper = torch.triu(torch.ones(n, n, dtype=torch.bool), 1)
    return torch.where(upper, float("nan"), a).to(dtype=dtype, device=device)


def rhs_bank(nb, n, k, seed, dtype, device):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=(nb, n, k))).to(dtype=dtype, device=device)


def run_k1(cov, layout):
    """K1 through the wrapper of ``layout`` on the bank-first ``cov``;
    returns bank-first deltas (N, 2n+1, n)."""
    if layout == "lanes":
        return kernels.sigma_deltas_lanes_cuda(cov.permute(2, 1, 0).contiguous()).permute(2, 0, 1)
    if layout == "bank-first":
        return kernels.sigma_deltas_cuda(cov.contiguous())
    # a permuted view of a lanes tensor: bank stride 1, read in place
    return kernels.sigma_deltas_cuda(cov.permute(2, 1, 0).contiguous().permute(2, 1, 0))


def run_k8(spd, rhs, layout):
    """K8 through the wrapper of ``layout``; returns bank-first X (N, n, k)."""
    if layout == "lanes":
        x_t = kernels.solve_spd_lanes_cuda(spd.permute(2, 1, 0).contiguous(), rhs.permute(1, 2, 0).contiguous())
        return x_t.permute(2, 0, 1)
    if layout == "bank-first":
        return kernels.solve_spd_cuda(spd.contiguous(), rhs.contiguous())
    # the smoother's right-hand side, Cᵀ of a contiguous C, and a strided system
    return kernels.solve_spd_cuda(spd.permute(2, 1, 0).contiguous().permute(2, 1, 0),
                                  rhs.transpose(1, 2).contiguous().transpose(1, 2))


def k1_err(out, ref):
    """Max |Δ| over the largest |entry| of each instance's deltas."""
    return ((out - ref).abs() / ref.abs().amax(dim=(1, 2), keepdim=True)).max().item()


def k8_err(x, ref, spd):
    """Max error of D·X over the largest |D·X| of its column and instance,
    D = √diag A: the equilibrated solve is accurate relative to that."""
    d = torch.sqrt(torch.diagonal(spd, dim1=1, dim2=2))[:, :, None]
    return ((x - ref).abs() * d / (ref * d).abs().amax(dim=1, keepdim=True)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("nb", [1, 7, 300])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_matches_plain(device, dtype, n, nb, layout):
    cov = spd_bank(nb, n, 100 * n + nb, dtype, device)
    k1 = cuda_lib.KERNELS["sigma_deltas"]
    before = k1.launches
    out = run_k1(cov, layout)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    ref = kernels.sigma_deltas_plain(cov)
    assert out.shape == (nb, 2 * n + 1, n) and bool(torch.isfinite(out).all())
    assert k1_err(out, ref) <= LIMIT[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("k", [1, 53, 70])
@pytest.mark.parametrize("nb", [1, 7, 300])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k8_matches_plain(device, dtype, n, nb, k, layout):
    spd = spd_bank(nb, n, 7 * n + nb + k, dtype, device)
    rhs = rhs_bank(nb, n, k, k, dtype, device)
    k8 = cuda_lib.KERNELS["solve_spd"]
    before = k8.launches
    x = run_k8(spd, rhs, layout)
    torch.cuda.synchronize()
    assert k8.launches == before + 1
    ref = kernels.solve_spd_plain(spd, rhs)
    assert x.shape == (nb, n, k) and bool(torch.isfinite(x).all())
    assert k8_err(x, ref, spd) <= LIMIT[dtype]


def run_k12(cov, layout):
    """K12 through the wrapper of ``layout`` on the bank-first ``cov``;
    returns bank-first factors (N, n, n)."""
    if layout == "lanes":
        return kernels.cholesky_lanes_cuda(cov.permute(2, 1, 0).contiguous()).permute(2, 1, 0)
    if layout == "bank-first":
        return kernels.cholesky_cuda(cov.contiguous())
    return kernels.cholesky_cuda(cov.permute(2, 1, 0).contiguous().permute(2, 1, 0))


def k12_err(out, ref, cov):
    """Max |ΔL(r, c)| over √A_rr: row r of the factor scales with it."""
    d = torch.sqrt(torch.diagonal(cov, dim1=1, dim2=2))[:, :, None]
    return ((out - ref).abs() / d).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("nb", [1, 7, 300])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k12_matches_plain(device, dtype, n, nb, layout):
    cov = spd_bank(nb, n, 300 * n + nb, dtype, device)
    k12 = cuda_lib.KERNELS["cholesky"]
    before = k12.launches
    out = run_k12(cov, layout)
    torch.cuda.synchronize()
    assert k12.launches == before + 1
    assert out.shape == (nb, n, n) and bool(torch.isfinite(out).all()) and bool((out.triu(1) == 0).all())
    assert k12_err(out, kernels.cholesky_plain(cov), cov) <= LIMIT[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_matrix_that_is_not_spd_comes_back_nan_alone(device, dtype, layout):
    nb, n, bad = 7, 53, 3
    cov = spd_bank(nb, n, 5, dtype, device)
    cov[bad, 10, 10] = -1.0
    rhs = rhs_bank(nb, n, 53, 6, dtype, device)
    keep = torch.arange(nb, device=device) != bad
    out, ref = run_k1(cov, layout), kernels.sigma_deltas_plain(cov)
    x, x_ref = run_k8(cov, rhs, layout), kernels.solve_spd_plain(cov, rhs)
    L, L_ref = run_k12(cov, layout), kernels.cholesky_plain(cov)
    torch.cuda.synchronize()
    # row 0 is the mean point's zero delta in both versions; every ± row is NaN
    assert bool(torch.isnan(out[bad, 1:]).all()) and bool((out[bad, 0] == 0).all())
    assert bool(torch.isnan(ref[bad, 1:]).all())
    assert bool(torch.isnan(x[bad]).all()) and bool(torch.isnan(x_ref[bad]).all())
    assert bool(torch.isnan(L[bad]).all()) and bool(torch.isnan(L_ref[bad]).all())
    assert bool(torch.isfinite(out[keep]).all()) and bool(torch.isfinite(x[keep]).all())
    assert bool(torch.isfinite(L[keep]).all())
    assert k1_err(out[keep], ref[keep]) <= LIMIT[dtype]
    assert k8_err(x[keep], x_ref[keep], cov[keep]) <= LIMIT[dtype]
    assert k12_err(L[keep], L_ref[keep], cov[keep]) <= LIMIT[dtype]


@pytest.mark.cuda
def test_n65_is_refused_on_the_card(device):
    k1, k8, k12 = cuda_lib.KERNELS["sigma_deltas"], cuda_lib.KERNELS["solve_spd"], cuda_lib.KERNELS["cholesky"]
    before = (k1.launches, k8.launches, k12.launches)
    cov = torch.eye(65, dtype=torch.float64, device=device).expand(3, 65, 65)
    rhs = torch.ones(3, 65, 2, dtype=torch.float64, device=device)
    for call in (lambda: kernels.sigma_deltas_cuda(cov), lambda: kernels.sigma_deltas_banked(cov),
                 lambda: kernels.sigma_deltas_lanes_cuda(cov.permute(2, 1, 0)),
                 lambda: kernels.solve_spd_cuda(cov, rhs), lambda: kernels.solve_spd_banked(cov, rhs),
                 lambda: kernels.solve_spd_lanes_cuda(cov.permute(2, 1, 0), rhs.permute(1, 2, 0)),
                 lambda: kernels.cholesky_cuda(cov), lambda: kernels.cholesky_banked(cov),
                 lambda: kernels.cholesky_lanes_cuda(cov.permute(2, 1, 0))):
        with pytest.raises(ValueError, match="n <= 64"):
            call()
    assert (k1.launches, k8.launches, k12.launches) == before


@pytest.mark.cuda
def test_entry_points_launch_once_per_call(device):
    cov = spd_bank(9, 53, 8, torch.float32, device)
    rhs = rhs_bank(9, 53, 4, 9, torch.float32, device)
    k1, k8, k12 = cuda_lib.KERNELS["sigma_deltas"], cuda_lib.KERNELS["solve_spd"], cuda_lib.KERNELS["cholesky"]
    before = (k1.launches, k8.launches, k12.launches)
    one = kernels.sigma_deltas_banked(cov[0])
    bank = kernels.sigma_deltas_banked(cov)
    lanes = kernels.sigma_deltas_lanes(cov.permute(2, 1, 0))
    x = kernels.solve_spd_banked(cov, rhs)
    x_one = kernels.solve_spd_banked(cov[0], rhs[0])
    L = kernels.cholesky_banked(cov)
    L_one = kernels.cholesky_fast(cov[0])
    L_view = kernels.cholesky_banked(cov.permute(2, 1, 0).contiguous().permute(2, 1, 0))
    torch.cuda.synchronize()
    assert (k1.launches, k8.launches, k12.launches) == (before[0] + 3, before[1] + 2, before[2] + 3)
    assert torch.equal(one, bank[0]) and torch.equal(lanes.permute(2, 0, 1), bank)
    assert torch.equal(x_one, x[0])
    assert torch.equal(L_one, L[0]) and torch.equal(L_view, L)


# ---------------------------------------------------------------------------
# the wrappers' layout, on the CPU, against a stand-in for the kernel
# ---------------------------------------------------------------------------


def _strided(ptr, dtype, shape, strides):
    """The tensor that ``shape`` and element ``strides`` describe at ``ptr``."""
    count = 1 + sum((s - 1) * st for s, st in zip(shape, strides))
    esize = torch.empty((), dtype=dtype).element_size()
    flat = torch.frombuffer((ctypes.c_char * (count * esize)).from_address(ptr), dtype=dtype, count=count)
    return torch.as_strided(flat, shape, strides)


class StandIn:
    """Records each launch and computes the kernel's function, as its C
    interface defines it, through the pointers and strides it was given."""

    def __init__(self, name):
        self.name, self.calls = name, []

    def __call__(self, dtype, *args):
        self.calls.append(args)
        if self.name in ("sigma_deltas", "cholesky"):
            a, a_s, out, o_s, (n, nb) = args[0], args[1:4], args[4], args[5:8], args[8:10]
            cov = _strided(a, dtype, (nb, n, n), a_s)
            if self.name == "cholesky":
                _strided(out, dtype, (nb, n, n), o_s).copy_(kernels.cholesky_plain(cov))
            else:
                _strided(out, dtype, (nb, 2 * n + 1, n), o_s).copy_(kernels.sigma_deltas_plain(cov))
        else:
            n, k, nb = args[12:15]
            spd = _strided(args[0], dtype, (nb, n, n), args[1:4])
            rhs = _strided(args[4], dtype, (nb, n, k), args[5:8])
            _strided(args[8], dtype, (nb, n, k), args[9:12]).copy_(kernels.solve_spd_plain(spd, rhs))


@pytest.fixture
def stand_in(monkeypatch):
    fakes = {name: StandIn(name) for name in ("sigma_deltas", "solve_spd", "cholesky")}
    for name, fake in fakes.items():
        monkeypatch.setattr(cuda_lib.KERNELS[name], "launch", fake)
    monkeypatch.setattr(cuda_lib, "stream_ptr", lambda device: None)
    return fakes


@pytest.mark.parametrize("layout", LAYOUTS)
def test_k1_wrappers_hand_the_kernel_their_input_in_place(stand_in, layout):
    cov = spd_bank(5, 11, 3, torch.float64, "cpu")
    lanes = cov.permute(2, 1, 0).contiguous()
    given = {"lanes": lanes, "bank-first": cov, "views": lanes.permute(2, 1, 0)}[layout]
    out = kernels.sigma_deltas_lanes_cuda(given).permute(2, 0, 1) if layout == "lanes" else \
        kernels.sigma_deltas_cuda(given)
    (args,) = stand_in["sigma_deltas"].calls
    assert args[0] == given.data_ptr()  # no copy of the input
    assert args[4] == out.data_ptr() and len(args) == 11  # no scratch
    torch.testing.assert_close(out, kernels.sigma_deltas_plain(cov), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_k8_wrappers_hand_the_kernel_their_inputs_in_place(stand_in, layout):
    spd = spd_bank(4, 12, 4, torch.float64, "cpu")
    rhs = rhs_bank(4, 12, 3, 5, torch.float64, "cpu")
    if layout == "lanes":
        a, b = spd.permute(2, 1, 0).contiguous(), rhs.permute(1, 2, 0).contiguous()
        x = kernels.solve_spd_lanes_cuda(a, b).permute(2, 0, 1)
    else:
        a, b = (spd, rhs) if layout == "bank-first" else \
            (spd.permute(2, 1, 0).contiguous().permute(2, 1, 0), rhs.transpose(1, 2).contiguous().transpose(1, 2))
        x = kernels.solve_spd_cuda(a, b)
    (args,) = stand_in["solve_spd"].calls
    assert (args[0], args[4]) == (a.data_ptr(), b.data_ptr())  # no copies of the inputs
    assert args[8] == x.data_ptr() and len(args) == 16  # one launch, no scratch
    torch.testing.assert_close(x, kernels.solve_spd_plain(spd, rhs), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_k12_wrappers_hand_the_kernel_their_input_in_place(stand_in, monkeypatch, layout):
    cov = spd_bank(6, 13, 7, torch.float64, "cpu")
    lanes = cov.permute(2, 1, 0).contiguous()
    given = {"lanes": lanes, "bank-first": cov, "views": lanes.permute(2, 1, 0)}[layout]
    allocated, at_launch = [], []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: allocated.append(empty(*a, **kw)) or allocated[-1])
    fake = stand_in["cholesky"]
    monkeypatch.setattr(cuda_lib.KERNELS["cholesky"], "launch",
                        lambda *a: at_launch.extend(t.data_ptr() for t in allocated) or fake(*a))
    out = kernels.cholesky_lanes_cuda(given).permute(2, 1, 0) if layout == "lanes" else kernels.cholesky_cuda(given)
    (args,) = fake.calls
    assert args[0] == given.data_ptr()  # no copy of the input
    assert args[4] == out.data_ptr() and len(args) == 11  # no scratch
    assert at_launch == [out.data_ptr()]  # the output is all the wrapper allocates
    torch.testing.assert_close(out, kernels.cholesky_plain(cov), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("call", ["sigma_deltas_cuda", "sigma_deltas_lanes_cuda", "solve_spd_cuda",
                                  "solve_spd_lanes_cuda", "cholesky_cuda", "cholesky_lanes_cuda"])
def test_wrappers_refuse_n65_before_the_kernel(stand_in, call):
    cov = torch.eye(65, dtype=torch.float64).expand(3, 65, 65)
    rhs = torch.ones(3, 65, 2, dtype=torch.float64)
    args = {"sigma_deltas_cuda": (cov,), "sigma_deltas_lanes_cuda": (cov.permute(2, 1, 0),),
            "solve_spd_cuda": (cov, rhs), "solve_spd_lanes_cuda": (cov.permute(2, 1, 0), rhs.permute(1, 2, 0)),
            "cholesky_cuda": (cov,), "cholesky_lanes_cuda": (cov.permute(2, 1, 0),)}[call]
    with pytest.raises(ValueError, match="n <= 64"):
        getattr(kernels, call)(*args)
    assert not any(fake.calls for fake in stand_in.values())

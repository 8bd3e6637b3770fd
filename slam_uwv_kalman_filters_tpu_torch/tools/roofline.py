"""The card's measured ceilings and the operation count of a mission tick:
the counterpart of ``tools/roofline.py``.

* :func:`measure_fma` launches K13 (``csrc/fma_probe.cu``) repeatedly on a
  block of elements held on the card, each launch's output the next one's
  ``a`` (a chained carry), and returns FLOP/s = 2·``CHAIN``·elements·launches
  over the seconds between two CUDA events. It launches K13 or raises.
* :func:`measure_hbm` times the streaming triad y ← c·x + y (two reads and a
  write of each element) in plain PyTorch, as the JAX tool leaves its triad
  to XLA outside any kernel, and returns bytes/s.
* :func:`measure_mxu` times a chain of 4096³ float32 products c ← a·c with a
  Ginibre ``a`` (spectral radius ~1, so the carry never settles) through
  cuBLAS (``torch.matmul``) with TF32 off: the library's full-float32 matrix
  ceiling, as the JAX tool's ``measure_mxu`` measures ``jnp.dot``'s.
* :func:`count_tick_flops` counts the operations of one mission tick on the
  bench's schedule (``MISSION_TICKS`` ticks: predict and acceleration every
  tick, DVL 5 Hz, pressure 2 Hz, ADCP 1 Hz, body efforts 10 Hz; the port's
  own copy, since ``bench.py`` imports JAX) with
  ``torch.utils.flop_counter.FlopCounterMode`` over the generic bank path on
  the CPU. It counts matrix products only (mm, bmm, addmm, einsum's bmm),
  not elementwise work, and a kernel op (K1's sigma deltas) counts as zero,
  where XLA's cost analysis behind the JAX count includes both: the port's
  count is lower by design and is not scaled to match.

:func:`fma_probe_plain` is K13's function in PyTorch: the tests hold it to a
NumPy chain and ``chip_smoke.py`` holds K13 to it.
"""

from __future__ import annotations

import torch

from ..ops import cuda_lib
from ..utils.device import resolve_device

__all__ = ["CHAIN", "ELEMENTS", "MISSION_TICKS", "count_tick_flops", "fma_probe_cuda", "fma_probe_plain", "measure_fma",
           "measure_hbm", "measure_mxu", "mission_bank"]

CHAIN = 512  # multiply-adds per element, over four independent chains (csrc/fma_probe.cu kChain)
ELEMENTS = 64 * 8 * 512 * 128  # the JAX probe's (8, 512, 128) block times its grid of 64


def fma_probe_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K13's function in PyTorch: four chains a_k ← a_k·b + a, CHAIN/4 steps
    each, from a, a+1, a+2, a+3; returns (a0+a1+a2+a3)·1e-3."""
    chains = [a, a + 1.0, a + 2.0, a + 3.0]
    for _ in range(CHAIN // 4):
        chains = [torch.addcmul(a, c, b) for c in chains]
    return (chains[0] + chains[1] + chains[2] + chains[3]) * 1e-3


def fma_probe_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K13 on the card: (n,) float32 ``a`` and ``b`` → (n,) float32."""
    if a.ndim != 1 or a.shape != b.shape or a.numel() < 1:
        raise ValueError(f"fma_probe: need two (n,) vectors, got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != torch.float32:
        raise TypeError(f"fma_probe: float32 only, got {a.dtype}")
    out = torch.empty_like(a)
    cuda_lib.check_lanes("fma_probe", a.device, a.dtype, a=a, b=b, out=out)
    cuda_lib.KERNELS["fma_probe"].launch(
        a.dtype, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), cuda_lib.stream_ptr(a.device)
    )
    return out


def _elapsed_s(fn, reps: int) -> float:
    """Seconds of ``reps`` calls between two CUDA events, after one warm call."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) * 1e-3


def measure_fma(launches: int = 32, elements: int = ELEMENTS, device=None) -> float:
    """The card's float32 FMA rate in FLOP/s, from ``launches`` chained K13
    launches over ``elements`` elements (the JAX probe's work per call)."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"measure_fma measures a CUDA device, got {device}")
    a = torch.full((elements,), 1.0000001, dtype=torch.float32, device=device)
    b = torch.full((elements,), 0.9999999, dtype=torch.float32, device=device)
    carry = [a]

    def chained():
        carry[0] = fma_probe_cuda(carry[0], b)

    seconds = _elapsed_s(chained, launches)
    return 2.0 * CHAIN * elements * launches / seconds


def measure_hbm(iters: int = 32, elements: int = 256 * 1024 * 1024, device=None) -> float:
    """The card's streaming bandwidth in bytes/s: ``iters`` in-place triads
    y ← c·x + y over ``elements`` float32 values (three transfers each)."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"measure_hbm measures a CUDA device, got {device}")
    x = torch.arange(elements, dtype=torch.float32, device=device) * 1e-9
    y = torch.ones(elements, dtype=torch.float32, device=device)
    seconds = _elapsed_s(lambda: y.add_(x, alpha=1.000001), iters)
    return 3.0 * 4.0 * elements * iters / seconds


def measure_mxu(n: int = 4096, products: int = 16, device=None) -> float:
    """The card's full-float32 matrix rate in FLOP/s through cuBLAS: a chain
    of ``products`` n³ products c ← a·c (each one's input the last one's
    output) over the seconds between two CUDA events, TF32 off."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"measure_mxu measures a CUDA device, got {device}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("measure_mxu measures full float32: TF32 must be off")
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((n, n), generator=gen, dtype=torch.float32, device=device) / n**0.5
    carry = [torch.randn((n, n), generator=gen, dtype=torch.float32, device=device)]

    def chained():
        carry[0] = torch.matmul(a, carry[0])

    seconds = _elapsed_s(chained, products)
    return 2.0 * n**3 * products / seconds


# bench.py's mission schedule (its FULL_TICKS and _*_AT), the port's own copy
MISSION_TICKS = 100
DVL_AT = lambda k: k % 20 == 19  # 5 Hz
PRESS_AT = lambda k: k % 50 == 49  # 2 Hz
ADCP_AT = lambda k: k % 100 == 99  # 1 Hz
EFF_AT = lambda k: k % 10 == 9  # 10 Hz


def mission_bank(bank: int, dtype, device, perturb=None):
    """bench.py's ``_pose_full_setup`` on the port: the mission filter built
    in float64, replicated ``bank`` times with the gyro's rotation rate,
    ``perturb(state, bank_state)`` applied if given (still float64), then
    the bank and its parameters cast to ``dtype``; with the measurements,
    each a (bank, m) tensor and its covariance, in ``dtype``."""
    from ..models import pose_ukf as pukf
    from ..ops import dynamics as dyn
    from ..ops import geodesy as geo
    from ..parallel import bank as bankmod
    from ..utils.config import default_pose_ukf_config

    cfg = default_pose_ukf_config()
    f64 = torch.float64
    state, params = pukf.init_from_pose(
        torch.zeros(3, dtype=f64), torch.eye(3, dtype=f64) * 0.01,
        torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=f64), torch.eye(3, dtype=f64) * 1e-4,
        cfg, dyn.default_uwv_parameters(device=device), imu_delta_t=0.01, device=device,
    )
    bs = bankmod.replicate(state, bank)
    bs = bs._replace(rotation_rate=torch.tensor([0.0, 0.0, 0.01], dtype=f64, device=device).expand(bank, 3)
                     .contiguous())
    if perturb is not None:
        bs = perturb(state, bs)
    g = float(geo.wgs84_gravity(cfg.location.latitude, cfg.location.altitude))
    eye = lambda m: torch.eye(m, dtype=dtype, device=device)
    row = lambda v: torch.tensor(v, dtype=dtype, device=device).expand(bank, len(v))
    meas = {
        "acc": (row([0.0, 0.0, g]), eye(3) * 4e-5), "dvl": (row([0.3, 0.0, 0.0]), eye(3) * 1e-3),
        "press": (row([float(cfg.hydrostatics.atmospheric_pressure)]), eye(1) * 2500.0),
        "adcp": (row([0.0, 0.0]), eye(2) * 1e-3), "eff": (row([0.0] * 6), eye(6)),
    }
    to = lambda tree: bankmod.tree_map(lambda a: a.to(dtype), tree)
    return to(bs), to(params), meas


def count_tick_flops(bank: int = 8, dtype=torch.float32) -> float:
    """Matrix-product FLOPs of one mission tick of one instance: the bench's
    ``MISSION_TICKS``-tick schedule through the generic bank path
    (``pose_ukf.*_bank``) on the CPU under ``FlopCounterMode``, divided by
    bank × ticks (the count is linear in the bank). Elementwise work and the
    kernel ops are not counted (module notes)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..models import pose_ukf as pukf

    bs, params, ms = mission_bank(bank, dtype, torch.device("cpu"))
    counter = FlopCounterMode(display=False)
    with counter:
        for k in range(MISSION_TICKS):
            bs = pukf.predict_bank(bs, params, 0.01)
            bs, _ = pukf.update_acceleration_bank(bs, params, *ms["acc"])
            if DVL_AT(k):
                bs, _ = pukf.update_velocity_bank(bs, params, *ms["dvl"])
            if PRESS_AT(k):
                bs, _ = pukf.update_pressure_bank(bs, params, *ms["press"])
            if ADCP_AT(k):
                bs, _ = pukf.update_water_velocity_bank(bs, params, *ms["adcp"], 0.5)
            if EFF_AT(k):
                rr = pukf.get_rotation_rate_bank(bs, params)
                bs, _ = pukf.update_body_efforts_bank(bs, params, *ms["eff"], rr)
    return counter.get_total_flops() / (bank * MISSION_TICKS)

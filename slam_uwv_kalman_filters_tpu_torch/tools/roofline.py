"""The card's measured ceilings: float32 FMA rate (kernel K13) and device
memory bandwidth — the counterpart of ``tools/roofline.py`` (its
``measure_vpu_fma`` and ``measure_hbm_bw``).

* :func:`measure_fma` launches K13 (``csrc/fma_probe.cu``) repeatedly on a
  block of elements held on the card, each launch's output the next one's
  ``a`` (a chained carry), and returns FLOP/s = 2·``CHAIN``·elements·launches
  over the seconds between two CUDA events. It launches K13 or raises.
* :func:`measure_hbm` times the streaming triad y ← c·x + y (two reads and a
  write of each element) in plain PyTorch, as the JAX tool leaves its triad
  to XLA outside any kernel, and returns bytes/s.

:func:`fma_probe_plain` is K13's function in PyTorch: the tests hold it to a
NumPy chain and ``chip_smoke.py`` holds K13 to it. The JAX tool's MXU probe
and algorithmic FLOP count are not kernels and are not ported.
"""

from __future__ import annotations

import torch

from ..ops import cuda_lib
from ..utils.device import resolve_device

__all__ = ["CHAIN", "ELEMENTS", "fma_probe_cuda", "fma_probe_plain", "measure_fma", "measure_hbm"]

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

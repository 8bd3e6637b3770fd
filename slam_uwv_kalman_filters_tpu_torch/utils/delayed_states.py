"""Delayed-state ring buffer — ``pose_estimation::DelayedStates<T>`` as a
fixed-size NamedTuple of tensors, the counterpart of
``slam_uwv_kalman_filters_tpu/utils/delayed_states.py``.

The reference declares the buffer for out-of-sequence XY-position fusion
(``src/PoseUKF.hpp:19,197``; ``pushState`` / ``getClosestState`` /
``fromSeconds`` at ``src/PoseUKF.cpp:470-472, 660-662``). Here it is a
circular buffer of static shape: :func:`push` writes the slot at ``head``
with a masked select and :func:`closest` takes an argmin over timestamp
distance with validity masking. Neither reads a value back to the host, so
a buffer on the card never makes the host wait. Every leaf may carry
leading bank axes (``parallel.bank.replicate(make_buffer(...), B)``): the
functions broadcast over them, with ``ts_us`` shared or one per instance.

Timestamps are always ``torch.int64`` **microseconds**, on every device, as
in the JAX package under x64 (how its tests run it) and the reference's
``fromSeconds``. The JAX package's int32-millisecond mode exists only for
runtimes without 64-bit integers and is not ported. Durations go through
:func:`from_seconds`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .device import resolve_device

__all__ = ["DelayedStates", "make_buffer", "push", "closest", "from_seconds", "ticks_per_second"]

_TICKS = 1_000_000


def ticks_per_second() -> int:
    """Integer ticks per second: microseconds, the reference's unit."""
    return _TICKS


def from_seconds(seconds):
    """``DelayedStates::fromSeconds`` — seconds → int64 microseconds. A host
    number or array converts in float64 with NumPy (a Python ``int`` for a
    scalar, an int64 CPU tensor otherwise); a tensor converts on its own
    device, whole and fractional seconds apart so the products stay exact to
    the input's resolution."""
    if not isinstance(seconds, torch.Tensor):
        ticks = np.round(np.asarray(seconds, np.float64) * _TICKS).astype(np.int64)
        return int(ticks) if ticks.ndim == 0 else torch.from_numpy(ticks)
    if not seconds.is_floating_point():
        return seconds.to(torch.int64) * _TICKS
    s = seconds.to(torch.float64)
    whole = torch.floor(s)
    return whole.to(torch.int64) * _TICKS + torch.round((s - whole) * _TICKS).to(torch.int64)


class DelayedStates(NamedTuple):
    timestamps: torch.Tensor  # (N,) int64 µs
    values: torch.Tensor  # (N, d)
    covs: torch.Tensor  # (N, d, d)
    head: torch.Tensor  # () int32 — next write slot
    count: torch.Tensor  # () int32 — valid entries (≤ N)
    max_delay_us: torch.Tensor  # () int64 µs — maximum accepted measurement delay


def make_buffer(capacity: int, dim: int, maximum_delay: float, dtype=torch.float64, device=None) -> DelayedStates:
    """Fixed-capacity buffer; ``maximum_delay`` in seconds mirrors the
    reference ``setupDelayedStateBuffer`` argument (``src/PoseUKF.hpp:130-133``).
    ``device=None`` builds on the card (see ``utils/device.py``)."""
    device = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=device)
    return DelayedStates(
        timestamps=torch.zeros(capacity, dtype=torch.int64, device=device),
        values=torch.zeros((capacity, dim), dtype=dtype, device=device),
        covs=torch.zeros((capacity, dim, dim), dtype=dtype, device=device),
        head=torch.zeros((), **i32),
        count=torch.zeros((), **i32),
        max_delay_us=torch.tensor(from_seconds(abs(maximum_delay)), dtype=torch.int64, device=device),
    )


def _as_ticks(buf: DelayedStates, ts_us):
    """``ts_us`` as int64 µs: a host value becomes a Python ``int`` (a kernel
    argument, never a copy to the card), a tensor moves to the buffer's
    device. An integer tensor of another width is refused rather than cast:
    it is not this buffer's unit (and a cast to a narrower type would
    wrap)."""
    if isinstance(ts_us, torch.Tensor):
        if not ts_us.is_floating_point() and ts_us.dtype != torch.int64:
            raise TypeError(f"timestamp dtype {ts_us.dtype} is not the buffer's int64 µs; use from_seconds")
        return ts_us.to(device=buf.timestamps.device, dtype=torch.int64)
    arr = np.asarray(ts_us)
    if arr.ndim == 0:
        return int(arr)
    return torch.from_numpy(arr.astype(np.int64)).to(buf.timestamps.device)


def _per_slot(ts):
    """A timestamp broadcast against the buffer's (..., N) slot axis."""
    return ts if isinstance(ts, int) else ts[..., None]


def push(buf: DelayedStates, ts_us, value: torch.Tensor, cov: torch.Tensor) -> DelayedStates:
    """``pushState(ts, state, cov)`` — overwrite the oldest slot; returns the
    new buffer (the old one is left as it was)."""
    cap = buf.timestamps.shape[-1]
    slot = torch.arange(cap, device=buf.head.device) == buf.head[..., None]  # (..., N)
    value = value.to(buf.values.dtype)
    cov = cov.to(buf.covs.dtype)
    return buf._replace(
        timestamps=torch.where(slot, _per_slot(_as_ticks(buf, ts_us)), buf.timestamps),
        values=torch.where(slot[..., None], value[..., None, :], buf.values),
        covs=torch.where(slot[..., None, None], cov[..., None, :, :], buf.covs),
        head=(buf.head + 1) % cap,
        count=torch.clamp(buf.count + 1, max=cap),
    )


def closest(buf: DelayedStates, ts_us):
    """``getClosestState(ts)`` → (value, cov, found).

    ``found`` is False when the buffer is empty or the nearest entry is
    farther than ``max_delay_us`` from the requested timestamp (the reference
    returns false when the delay exceeds the configured maximum). Of equally
    near entries the lowest slot wins, as in JAX."""
    cap = buf.timestamps.shape[-1]
    valid = torch.arange(cap, device=buf.count.device) < buf.count[..., None]
    dist = (buf.timestamps - _per_slot(_as_ticks(buf, ts_us))).abs()
    dist = torch.where(valid, dist, torch.iinfo(torch.int64).max)
    best = torch.argmin(dist, dim=-1, keepdim=True)  # (..., 1)
    found = (buf.count > 0) & (torch.gather(dist, -1, best)[..., 0] <= buf.max_delay_us)
    d = buf.values.shape[-1]
    value = torch.gather(buf.values, -2, best[..., None].expand(*best.shape, d))[..., 0, :]
    cov = torch.gather(buf.covs, -3, best[..., None, None].expand(*best.shape, d, d))[..., 0, :, :]
    return value, cov, found

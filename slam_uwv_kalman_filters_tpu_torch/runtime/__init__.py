"""Native host-side runtime (ctypes over the repository's
``runtime/libuwv_runtime.so``) — the port's own copy of the bindings of
``slam_uwv_kalman_filters_tpu/runtime/__init__.py``:

* :func:`pack_schedule` — the irregular-event-stream → dense-tick-schedule
  packer feeding ``models/pose_driver.py`` (latest wins per cell, µs ticks);
* :func:`forward_fill` — input-sensor semantics (gyro and effort caches hold
  the last value, ``src/PoseUKF.cpp:492-496``);
* :class:`NativeDelayedStates` — ``pose_estimation::DelayedStates<T>`` for
  host-side out-of-sequence bookkeeping (the buffer that lives on the card
  is ``utils/delayed_states.py``);
* :class:`StreamPacker` — the incremental event-stream → tick-window packer
  of online ingest.

The library is built from ``runtime/src/uwv_runtime.cpp`` by
``runtime/Makefile`` at first use (:func:`build`); where no compiler is
available every entry point falls back to an equivalent NumPy
implementation, so the API never depends on the native build. This module
imports no PyTorch and nothing of the JAX package.
"""

from __future__ import annotations

import ctypes
import fcntl
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["build", "native_available", "pack_schedule", "forward_fill", "NativeDelayedStates", "StreamPacker"]

_REPO_ROOT = Path(__file__).resolve().parents[2]
_RUNTIME_DIR = _REPO_ROOT / "runtime"
_LIB_PATH = _RUNTIME_DIR / "libuwv_runtime.so"
_LOCK_PATH = _REPO_ROOT / "build" / "runtime.lock"
_lib: Optional[ctypes.CDLL] = None
_load_failed = False  # a failed build is not retried on the hot ingest path


def build(force: bool = False) -> bool:
    """Compile the native runtime with ``make -C runtime`` (a no-op when the
    library is current). Processes of this package that build it at the same
    time wait on a lock file, so none loads a library another is still
    writing."""
    try:
        _LOCK_PATH.parent.mkdir(parents=True, exist_ok=True)
        with open(_LOCK_PATH, "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            cmd = ["make", "-C", str(_RUNTIME_DIR)] + (["-B"] if force else [])
            subprocess.run(cmd, check=True, capture_output=True)
        return _LIB_PATH.exists()
    except (subprocess.CalledProcessError, OSError):
        return _LIB_PATH.exists() and not force  # no compiler: use a prebuilt library as is


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    if not build():
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        # a corrupt library, or one built with -march=native on another CPU
        _load_failed = True
        return None
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.uwv_pack_schedule.restype = i64
    lib.uwv_pack_schedule.argtypes = [i64p, i32p, f64p, i64, i32, i32p, i32, i64, i64, i64, f64p, u8p]
    lib.uwv_forward_fill.restype = None
    lib.uwv_forward_fill.argtypes = [f64p, u8p, i64, i32, f64p]
    lib.uwv_delayed_states_new.restype = ctypes.c_void_p
    lib.uwv_delayed_states_new.argtypes = [i64, i32, ctypes.c_double]
    lib.uwv_delayed_states_free.argtypes = [ctypes.c_void_p]
    lib.uwv_delayed_states_push.argtypes = [ctypes.c_void_p, i64, f64p, f64p]
    lib.uwv_delayed_states_closest.restype = i32
    lib.uwv_delayed_states_closest.argtypes = [ctypes.c_void_p, i64, f64p, f64p]
    lib.uwv_stream_new.restype = ctypes.c_void_p
    lib.uwv_stream_new.argtypes = [i32, i32, i32p, i64, i64, i64]
    lib.uwv_stream_free.argtypes = [ctypes.c_void_p]
    lib.uwv_stream_push.restype = i64
    lib.uwv_stream_push.argtypes = [ctypes.c_void_p, i64p, i32p, f64p, i64]
    lib.uwv_stream_ready.restype = i32
    lib.uwv_stream_ready.argtypes = [ctypes.c_void_p]
    lib.uwv_stream_pop.restype = i64
    lib.uwv_stream_pop.argtypes = [ctypes.c_void_p, i32, f64p, u8p]
    lib.uwv_stream_dropped.restype = i64
    lib.uwv_stream_dropped.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def pack_schedule(
    timestamps_us: np.ndarray,
    sensor_ids: np.ndarray,
    payloads: np.ndarray,
    sensor_dims: np.ndarray,
    t0_us: int,
    dt_us: int,
    n_ticks: int,
):
    """Pack an irregular event stream into dense per-sensor tick arrays.

    Returns (values [n_sensors, n_ticks, stride], valid [n_sensors, n_ticks],
    dropped count). The latest event of a (sensor, tick) cell wins; events
    before ``t0_us``, past the last tick or of an unknown sensor are
    dropped."""
    timestamps_us = np.ascontiguousarray(timestamps_us, np.int64)
    sensor_ids = np.ascontiguousarray(sensor_ids, np.int32)
    payloads = np.ascontiguousarray(payloads, np.float64)
    sensor_dims = np.ascontiguousarray(sensor_dims, np.int32)
    n_sensors = len(sensor_dims)
    if n_sensors <= 0:
        raise ValueError("sensor_dims is empty")
    if dt_us <= 0:
        raise ValueError(f"dt_us must be positive, got {dt_us} (rate > 1e6 Hz?)")
    if n_ticks < 0:
        raise ValueError(f"n_ticks must be non-negative, got {n_ticks}")
    stride = payloads.shape[1] if payloads.ndim == 2 else 1
    payloads = payloads.reshape(len(timestamps_us), stride)

    lib = _load()
    values = np.zeros((n_sensors, n_ticks, stride), np.float64)
    valid = np.zeros((n_sensors, n_ticks), np.uint8)
    if lib is not None:
        dropped = lib.uwv_pack_schedule(
            timestamps_us, sensor_ids, payloads, len(timestamps_us),
            stride, sensor_dims, n_sensors, t0_us, dt_us, n_ticks,
            values.reshape(-1), valid.reshape(-1),
        )
        if dropped < 0:
            raise RuntimeError(f"native packer rejected the arguments (code {dropped})")
        return values, valid.astype(bool), int(dropped)

    # NumPy fallback — the same latest-wins semantics
    dropped = 0
    winner = np.full((n_sensors, n_ticks), np.iinfo(np.int64).min, np.int64)
    for e in range(len(timestamps_us)):
        sid = int(sensor_ids[e])
        if not (0 <= sid < n_sensors):
            dropped += 1
            continue
        rel = int(timestamps_us[e]) - t0_us
        if rel < 0 or rel // dt_us >= n_ticks:
            dropped += 1
            continue
        tick = rel // dt_us
        if timestamps_us[e] < winner[sid, tick]:
            continue
        winner[sid, tick] = timestamps_us[e]
        d = int(sensor_dims[sid])
        values[sid, tick, :d] = payloads[e, :d]
        valid[sid, tick] = 1
    return values, valid.astype(bool), dropped


def forward_fill(values: np.ndarray, valid: np.ndarray, initial: np.ndarray):
    """Input-sensor semantics: every tick carries the last received value.
    ``initial`` may be shorter than the row stride and is zero-extended, so
    the native and NumPy paths fill the whole row alike. Returns (values,
    valid all True)."""
    values = np.ascontiguousarray(values, np.float64)
    valid_u8 = np.ascontiguousarray(valid, np.uint8)
    initial = np.ascontiguousarray(initial, np.float64).reshape(-1)
    stride = values.shape[1]
    if len(initial) > stride:
        raise ValueError(f"initial has {len(initial)} entries for stride {stride}")
    if len(initial) < stride:
        initial = np.concatenate([initial, np.zeros(stride - len(initial))])
    lib = _load()
    if lib is not None and stride <= 64:  # the native last-value buffer holds 64
        lib.uwv_forward_fill(values, valid_u8, values.shape[0], stride, initial)
        return values, valid_u8.astype(bool)
    last = initial.copy()
    for t in range(values.shape[0]):
        if valid_u8[t]:
            last = values[t].copy()
        else:
            values[t] = last
            valid_u8[t] = 1
    return values, valid_u8.astype(bool)


class NativeDelayedStates:
    """ctypes handle over the C++ DelayedStates ring buffer (float64 values
    and covariances, int64 µs timestamps); the NumPy fallback keeps the same
    semantics in a list."""

    def __init__(self, capacity: int, dim: int, maximum_delay_s: float):
        if capacity <= 0 or dim <= 0:
            raise ValueError(f"capacity and dim must be positive, got {capacity}, {dim}")
        self._dim = dim
        self._lib = _load()
        if self._lib is not None:
            self._h = self._lib.uwv_delayed_states_new(capacity, dim, maximum_delay_s)
            if not self._h:
                raise ValueError("native DelayedStates rejected the arguments")
        else:
            self._h = None
            self._cap = capacity
            self._max_us = int(abs(maximum_delay_s) * 1e6)
            self._entries: list = []

    @property
    def native(self) -> bool:
        return self._h is not None

    def push(self, ts_us: int, value, cov) -> None:
        value = np.ascontiguousarray(value, np.float64)
        cov = np.ascontiguousarray(cov, np.float64)
        if value.size != self._dim or cov.size != self._dim * self._dim:
            # the native side copies dim and dim² doubles whatever it is given
            raise ValueError(
                f"push expects value ({self._dim},) and cov ({self._dim},{self._dim}); "
                f"got {value.shape} and {cov.shape}"
            )
        if self._h is not None:
            self._lib.uwv_delayed_states_push(self._h, int(ts_us), value, cov)
        else:
            self._entries.append((int(ts_us), value.copy(), cov.copy()))
            if len(self._entries) > self._cap:
                self._entries.pop(0)

    def closest(self, ts_us: int):
        """→ (value, cov, found)"""
        if self._h is not None:
            value = np.zeros(self._dim, np.float64)
            cov = np.zeros((self._dim, self._dim), np.float64)
            ok = self._lib.uwv_delayed_states_closest(self._h, int(ts_us), value, cov.reshape(-1))
            return value, cov, bool(ok)
        if not self._entries:
            return np.zeros(self._dim), np.zeros((self._dim, self._dim)), False
        best = min(self._entries, key=lambda e: abs(e[0] - ts_us))
        found = abs(best[0] - ts_us) <= self._max_us
        return best[1], best[2], found

    def __del__(self):
        if getattr(self, "_h", None) is not None and self._lib is not None:
            self._lib.uwv_delayed_states_free(self._h)


class StreamPacker:
    """Incremental event-stream → tick-window packer (online ingest).

    ``push`` stages batches of (possibly out-of-order) events; ``pop``
    releases consecutive windows — ``(window_index, values [n_sensors,
    ticks, stride], valid)`` — once the push watermark (the newest timestamp
    seen) has passed their end. The latest event of a (sensor, tick) cell
    wins. Events for windows already released are late and counted in
    :attr:`dropped`. Native C++ (``uwv_stream_*``) with an equivalent NumPy
    fallback."""

    def __init__(self, sensor_dims, t0_us: int, dt_us: int, window_ticks: int,
                 payload_stride: Optional[int] = None):
        sensor_dims = np.ascontiguousarray(sensor_dims, np.int32)
        if sensor_dims.size == 0:
            raise ValueError("sensor_dims is empty")
        if dt_us <= 0 or window_ticks <= 0:
            raise ValueError(f"dt_us and window_ticks must be positive, got {dt_us}, {window_ticks}")
        self._dims = sensor_dims
        self._n_sensors = int(sensor_dims.size)
        self._stride = int(payload_stride or max(1, int(sensor_dims.max())))
        if self._stride < int(sensor_dims.max()):
            raise ValueError(
                f"payload_stride {self._stride} is narrower than the widest sensor ({int(sensor_dims.max())})"
            )
        self._t0 = int(t0_us)
        self._dt = int(dt_us)
        self._ticks = int(window_ticks)
        self._lib = _load()
        if self._lib is not None:
            self._h = self._lib.uwv_stream_new(
                self._n_sensors, self._stride, sensor_dims, self._t0, self._dt, self._ticks
            )
            if not self._h:
                raise ValueError("native StreamPacker rejected the arguments")
        else:
            self._h = None
            self._next_window = 0
            self._watermark = np.iinfo(np.int64).min
            self._dropped = 0
            self._staged: dict = {}

    @property
    def native(self) -> bool:
        return self._h is not None

    @property
    def dropped(self) -> int:
        if self._h is not None:
            return int(self._lib.uwv_stream_dropped(self._h))
        return self._dropped

    def push(self, timestamps_us, sensor_ids, payloads) -> int:
        """Stage events; returns the number dropped in this call."""
        ts = np.ascontiguousarray(timestamps_us, np.int64)
        ids = np.ascontiguousarray(sensor_ids, np.int32)
        pay = np.ascontiguousarray(payloads, np.float64)
        if pay.ndim == 1:
            pay = pay.reshape(len(ts), -1)
        if pay.shape[1] != self._stride:
            padded = np.zeros((len(ts), self._stride), np.float64)
            padded[:, : pay.shape[1]] = pay[:, : self._stride]
            pay = padded
        if self._h is not None:
            return int(self._lib.uwv_stream_push(self._h, ts, ids, pay, len(ts)))
        span = self._dt * self._ticks
        dropped = 0
        for e in range(len(ts)):
            sid = int(ids[e])
            rel = int(ts[e]) - self._t0
            if not (0 <= sid < self._n_sensors) or rel < 0:
                dropped += 1
                continue
            w = rel // span
            if w < self._next_window:
                dropped += 1
                continue
            win = self._staged.setdefault(
                w,
                (
                    np.zeros((self._n_sensors, self._ticks, self._stride)),
                    np.zeros((self._n_sensors, self._ticks), np.uint8),
                    np.full((self._n_sensors, self._ticks), np.iinfo(np.int64).min, np.int64),
                ),
            )
            tick = (rel - w * span) // self._dt
            if ts[e] < win[2][sid, tick]:
                continue
            win[2][sid, tick] = ts[e]
            win[1][sid, tick] = 1
            d = int(self._dims[sid])
            win[0][sid, tick, :d] = pay[e, :d]
            if int(ts[e]) > self._watermark:
                self._watermark = int(ts[e])
        self._dropped += dropped
        return dropped

    def ready(self) -> bool:
        """True if the next in-order window can be released."""
        if self._h is not None:
            return bool(self._lib.uwv_stream_ready(self._h))
        end = self._t0 + (self._next_window + 1) * self._dt * self._ticks
        return self._watermark >= end

    def pop(self, force: bool = False):
        """Release the next in-order window → (index, values, valid) or None.
        A window with no staged events releases as an all-invalid tick grid;
        ``force=True`` flushes at stream end (releases before the watermark
        has passed the window's end)."""
        if self._h is not None:
            values = np.zeros((self._n_sensors, self._ticks, self._stride), np.float64)
            valid = np.zeros((self._n_sensors, self._ticks), np.uint8)
            w = self._lib.uwv_stream_pop(self._h, 1 if force else 0, values.reshape(-1), valid.reshape(-1))
            if w < 0:
                return None
            return int(w), values, valid.astype(bool)
        if not self.ready():
            behind = self._watermark >= self._t0 + self._next_window * self._dt * self._ticks
            if not (force and (self._staged or behind)):
                return None
        w = self._next_window
        self._next_window += 1
        win = self._staged.pop(w, None)
        if win is None:
            return (
                w,
                np.zeros((self._n_sensors, self._ticks, self._stride)),
                np.zeros((self._n_sensors, self._ticks), bool),
            )
        return w, win[0], win[1].astype(bool)

    def __del__(self):
        if getattr(self, "_h", None) is not None and self._lib is not None:
            self._lib.uwv_stream_free(self._h)

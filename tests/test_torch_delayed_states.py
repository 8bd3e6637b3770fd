"""The port's delayed-state buffer (``utils/delayed_states``) held exactly to
the JAX package's (x64: int64 µs ticks) — push, lookup, wraparound, the
horizon and the empty buffer, solo and banked with per-instance timestamps,
a JAX buffer carried across by ``utils/convert`` and back — and the port's
``pack_schedule`` / ``NativeDelayedStates`` held exactly to the JAX runtime's,
with the native library and with the port's NumPy fallback (its ``_load``
patched to find no library), as tests/test_torch_runtime.py does for the
StreamPacker. Everything is exact: integer timestamps, copied values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_uwv_kalman_filters_tpu import runtime as jrt
from slam_uwv_kalman_filters_tpu.parallel import bank as jbank
from slam_uwv_kalman_filters_tpu.utils import delayed_states as jds
from slam_uwv_kalman_filters_tpu_torch import runtime as trt
from slam_uwv_kalman_filters_tpu_torch.parallel import bank as tbank
from slam_uwv_kalman_filters_tpu_torch.utils import delayed_states as tds
from slam_uwv_kalman_filters_tpu_torch.utils.convert import from_numpy, to_numpy


def _same(port, ref):
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p), np.asarray(r))


def test_from_seconds_and_ticks_match_jax():
    assert tds.ticks_per_second() == jds.ticks_per_second() == 1_000_000
    for s in (0.0, 0.01, 0.97, 1.5, 3600.123456, 86400.0 * 24.5):
        assert tds.from_seconds(s) == int(jds.from_seconds(s))
    secs = np.array([0.01, 0.5, 12.345678])
    np.testing.assert_array_equal(tds.from_seconds(torch.from_numpy(secs)).numpy(),
                                  np.asarray(jax.jit(jds.from_seconds)(jnp.asarray(secs))))
    np.testing.assert_array_equal(tds.from_seconds(secs).numpy(), np.asarray(jds.from_seconds(secs)))


def test_push_lookup_wraparound_and_horizon_match_jax():
    rng = np.random.default_rng(3)
    ours = tds.make_buffer(8, 2, 2.0, device="cpu")
    ref = jds.make_buffer(8, 2, 2.0)
    for name in ("values", "covs"):  # empty buffer
        assert getattr(ours, name).shape == getattr(ref, name).shape
    _same(tds.closest(ours, tds.from_seconds(0.0)), jds.closest(ref, jds.from_seconds(0.0)))
    for k in range(12):  # wraps around after 8
        ts, v, c = 0.1 * k, rng.normal(size=2), np.eye(2) * (k + 1.0)
        ours = tds.push(ours, tds.from_seconds(ts), torch.from_numpy(v), torch.from_numpy(c))
        ref = jds.push(ref, jds.from_seconds(ts), jnp.asarray(v), jnp.asarray(c))
        _same(ours, ref)
    for q in (0.0, 0.42, 0.97, 1.05, 3.1, 100.0):  # ties break low; beyond 2 s not found
        _same(tds.closest(ours, tds.from_seconds(q)), jds.closest(ref, jds.from_seconds(q)))
    assert not bool(tds.closest(ours, tds.from_seconds(100.0))[2])
    with pytest.raises(TypeError, match="int64"):
        tds.closest(ours, torch.tensor(5, dtype=torch.int32))


def test_bank_buffer_with_per_instance_timestamps_matches_vmapped_jax():
    rng = np.random.default_rng(4)
    nb = 5
    ours = tbank.replicate(tds.make_buffer(6, 2, 0.3, device="cpu"), nb)
    ref = jbank.replicate(jds.make_buffer(6, 2, 0.3), nb)
    for k in range(9):
        ts = (np.arange(nb) * 7_000 + k * 100_000).astype(np.int64)
        v, c = rng.normal(size=(nb, 2)), np.broadcast_to(np.eye(2) * (k + 1.0), (nb, 2, 2)).copy()
        ours = tds.push(ours, torch.from_numpy(ts), torch.from_numpy(v), torch.from_numpy(c))
        ref = jax.vmap(jds.push)(ref, jnp.asarray(ts), jnp.asarray(v), jnp.asarray(c))
        _same(ours, ref)
    q = np.array([0, 450_000, 790_000, 1_200_000, 5_000_000], np.int64)
    _same(tds.closest(ours, torch.from_numpy(q)), jax.vmap(jds.closest)(ref, jnp.asarray(q)))
    shared = 650_000  # one timestamp for every instance
    _same(tds.closest(ours, shared), jax.vmap(jds.closest, in_axes=(0, None))(ref, jnp.asarray(shared)))


def test_a_jax_buffer_converts_to_the_port_and_back():
    ref = jds.make_buffer(4, 2, 1.0)
    for k in range(6):
        ref = jds.push(ref, jds.from_seconds(0.2 * k), jnp.asarray([k, -k], jnp.float64), jnp.eye(2) * k)
    ours = from_numpy(jax.tree.map(np.asarray, ref), device="cpu")
    assert isinstance(ours, tds.DelayedStates) and ours.timestamps.dtype == torch.int64
    _same(ours, ref)
    _same(tds.closest(ours, tds.from_seconds(0.55)), jds.closest(ref, jds.from_seconds(0.55)))
    back = to_numpy(ours)
    _same(back, ref)


@pytest.fixture(params=["native", "numpy"])
def port_rt(request, monkeypatch):
    if request.param == "native":
        assert trt.build() and trt.native_available(), "the native runtime must build here"
    else:
        monkeypatch.setattr(trt, "_load", lambda: None)
    return request.param


def _jax_rt(mode, monkeypatch):
    """The JAX runtime in the same mode (its NumPy fallback returns the
    nearest entry's value beside found=False, where the library returns
    zeros)."""
    if mode == "numpy":
        monkeypatch.setattr(jrt, "_load", lambda: None)
    return jrt


def test_native_delayed_states_match_jax_runtime_and_buffer(port_rt, monkeypatch):
    ours, ref = trt.NativeDelayedStates(8, 2, 1.0), _jax_rt(port_rt, monkeypatch).NativeDelayedStates(8, 2, 1.0)
    assert ours.native == (port_rt == "native")
    buf = tds.make_buffer(8, 2, 1.0, device="cpu")
    for k in range(12):
        ts, v, c = k * 100_000, np.array([float(k), -float(k)]), np.eye(2) * (k + 1)
        ours.push(ts, v, c)
        ref.push(ts, v, c)
        buf = tds.push(buf, ts, torch.from_numpy(v), torch.from_numpy(c))
    for q in (450_000, 900_000, 1_150_000, 99_000_000):
        got, want = ours.closest(q), ref.closest(q)
        _same(got, want)
        assert got[2] == bool(tds.closest(buf, q)[2])
        if got[2]:
            np.testing.assert_array_equal(got[0], tds.closest(buf, q)[0].numpy())
    with pytest.raises(ValueError, match="push expects"):
        ours.push(0, np.zeros(3), np.eye(2))
    with pytest.raises(ValueError):
        trt.NativeDelayedStates(0, 2, 1.0)


def test_pack_schedule_matches_jax_runtime(port_rt):
    rng = np.random.default_rng(9)
    n = 400
    ts = np.sort(rng.integers(-5_000, 2_100_000, n)).astype(np.int64)
    ts[10] = ts[11]  # a tie in one cell
    sid = rng.integers(-1, 4, n).astype(np.int32)  # -1 and 3 are unknown sensors
    pay = rng.normal(size=(n, 3))
    dims = np.array([3, 3, 1], np.int32)
    perm = rng.permutation(n)  # arrival out of order: the latest timestamp still wins
    got = trt.pack_schedule(ts[perm], sid[perm], pay[perm], dims, 0, 10_000, 200)
    want = jrt.pack_schedule(ts[perm], sid[perm], pay[perm], dims, 0, 10_000, 200)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2] > 0 and got[1].any()
    with pytest.raises(ValueError, match="dt_us"):
        trt.pack_schedule(ts, sid, pay, dims, 0, 0, 10)
    with pytest.raises(ValueError, match="sensor_dims"):
        trt.pack_schedule(ts, sid, pay, np.zeros(0, np.int32), 0, 10_000, 10)

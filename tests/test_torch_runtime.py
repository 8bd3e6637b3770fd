"""The port's own copy of the online runtime (``StreamPacker``,
``forward_fill``) held exactly to the JAX package's runtime module, on the
seeded event stream of examples/online_estimator.py (irregular, shuffled gyro
/ DVL / pressure packets): with the native library, and with the port's NumPy
fallback (its ``_load`` patched to find no library)."""

import sys
from pathlib import Path

import numpy as np
import pytest

from slam_uwv_kalman_filters_tpu import runtime as jrt
from slam_uwv_kalman_filters_tpu_torch import runtime as trt

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
from online_estimator import DVL, GYRO, PRESS, make_event_chunk  # noqa: E402

RATE = 100.0
DIMS = np.asarray([3, 3, 1], np.int32)


def _chunks(seconds=3):
    rng = np.random.default_rng(7)
    return [make_event_chunk(rng, int(s * 1e6), 1.0, RATE, np.array([0.4, -0.1, 0.0]), -12.0, 9.8209, 1027.0,
                             101325.0) for s in range(seconds)]


@pytest.fixture(params=["native", "numpy"])
def port_rt(request, monkeypatch):
    if request.param == "native":
        assert trt.build() and trt.native_available(), "the native runtime must build here"
    else:
        monkeypatch.setattr(trt, "_load", lambda: None)
    return request.param


def test_stream_packer_matches_jax_runtime(port_rt):
    assert jrt.native_available()
    kw = dict(t0_us=0, dt_us=int(1e6 / RATE), window_ticks=int(RATE), payload_stride=6)
    ours, ref = trt.StreamPacker(DIMS, **kw), jrt.StreamPacker(DIMS, **kw)
    assert ours.native == (port_rt == "native")
    last_ours = last_ref = np.zeros(3)
    for sec, (ts, ids, pay) in enumerate(_chunks()):
        assert ours.push(ts, ids, pay) == ref.push(ts, ids, pay)
        assert ours.ready() == ref.ready()
        got, want = ours.pop(force=True), ref.pop(force=True)
        assert got[0] == want[0] == sec
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        assert got[2][DVL].sum() >= 9 and got[2][PRESS].sum() >= 19  # jitter moves edge events
        filled, ok = trt.forward_fill(got[1][GYRO], got[2][GYRO], last_ours)
        filled_ref, ok_ref = jrt.forward_fill(want[1][GYRO], want[2][GYRO], last_ref)
        np.testing.assert_array_equal(filled, filled_ref)
        np.testing.assert_array_equal(ok, ok_ref)
        assert ok.all()
        last_ours, last_ref = filled[-1, :3].copy(), filled_ref[-1, :3].copy()
    # a late event (its window already released) and an unknown sensor are dropped
    before = ref.dropped  # jittered events of a window already released
    late = (np.array([150_000, 3_500_000], np.int64), np.array([GYRO, 7], np.int32), np.zeros((2, 6)))
    assert ours.push(*late) == ref.push(*late) == 2
    assert ours.dropped == ref.dropped == before + 2
    assert ours.pop() is None and ref.pop() is None  # the watermark has not passed window 3


def test_forward_fill_fills_and_extends(port_rt):
    rng = np.random.default_rng(8)
    values = rng.normal(size=(12, 6))
    valid = rng.uniform(size=12) < 0.4
    valid[0] = False
    got = trt.forward_fill(values.copy(), valid, np.array([1.0, 2.0, 3.0]))
    want = jrt.forward_fill(values.copy(), valid, np.array([1.0, 2.0, 3.0]))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0][0], [1.0, 2.0, 3.0, 0.0, 0.0, 0.0])
    with pytest.raises(ValueError, match="stride"):
        trt.forward_fill(values, valid, np.zeros(7))

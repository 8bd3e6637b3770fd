"""The port's tracing hooks (``utils/tracing.py``) on the CPU: ``trace``
writes one TensorBoard trace file into its directory naming the annotated
spans and the operators run under it, ``host_tracer_level`` records input
shapes from 2 and refuses values outside 0–3, ``annotate`` is PyTorch's
``record_function``, and ``Throughput`` counts steps with its sync points,
with the JAX module's public names and ``Throughput`` contract.
"""

import json

import pytest
import torch

from slam_uwv_kalman_filters_tpu.utils import tracing as jtr
from slam_uwv_kalman_filters_tpu_torch.utils import tracing


def test_public_names_match_the_jax_module():
    assert tracing.__all__ == jtr.__all__
    assert tracing.annotate is torch.profiler.record_function


def _trace_file(log_dir):
    files = sorted(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1, files
    return json.loads(files[0].read_text())


@pytest.mark.parametrize("level", [None, 2])
def test_trace_writes_a_trace_with_the_annotated_span(tmp_path, level):
    a = torch.randn(32, 32, dtype=torch.float64)
    with tracing.trace(tmp_path, host_tracer_level=level):
        with tracing.annotate("bank_step"):
            b = torch.linalg.cholesky(a @ a.T + 32 * torch.eye(32, dtype=torch.float64))
    assert torch.isfinite(b).all()
    events = _trace_file(tmp_path)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "bank_step" in names and "aten::linalg_cholesky" in names
    shapes = [e for e in events if e.get("name") == "aten::mm" and "Input Dims" in e.get("args", {})]
    assert bool(shapes) == (level == 2)


def test_trace_refuses_a_host_tracer_level_outside_0_to_3(tmp_path):
    with pytest.raises(ValueError, match="host_tracer_level"):
        with tracing.trace(tmp_path, host_tracer_level=4):
            pass


def test_throughput_counts_steps_between_sync_points():
    for cls in (tracing.Throughput, jtr.Throughput):  # the same contract as JAX's
        t = cls()
        with pytest.raises(RuntimeError, match="before start"):
            t.rate()
    t = tracing.Throughput()
    x = (torch.ones(4), (torch.zeros(2),))
    t.start(sync_on=x)
    t.add(1000)
    t.add(24)
    r = t.rate(sync_on=x)
    assert t._steps == 1024 and 0 < r < float("inf")
    t.start()
    assert t._steps == 0

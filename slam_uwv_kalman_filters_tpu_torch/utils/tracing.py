"""Profiling and tracing hooks — the counterpart of
``slam_uwv_kalman_filters_tpu/utils/tracing.py``.

:func:`trace` captures a TensorBoard-viewable trace of a block with
``torch.profiler`` (host operators, and the card's kernels where one is
present); :func:`annotate` names a span in it; :class:`Throughput` is the
steps/s counter with explicit device-sync boundaries.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

from ..parallel.bank import tree_leaves

__all__ = ["trace", "Throughput", "annotate"]


@contextlib.contextmanager
def trace(log_dir: str, *, host_tracer_level: int | None = None) -> Iterator[profile]:
    """Capture a trace of the enclosed block into ``log_dir`` (one
    ``*.pt.trace.json`` per capture, TensorBoard's and Perfetto's format):

        with tracing.trace("/tmp/tb"):
            ls = predict_lanes(ls, params, dt)

    The profiler records the host's operators and, where a card is present,
    its kernels and copies (CUPTI). ``host_tracer_level`` sets the host
    side's verbosity, as JAX's 0–3 does: 0 records no host operators (on a
    machine without a card there is nothing else, so the host stays on), 1
    (and ``None``, the default) the operators, 2 also their input shapes, 3
    also their Python stacks. Yields the profiler."""
    if host_tracer_level not in (None, 0, 1, 2, 3):
        raise ValueError(f"host_tracer_level must be 0-3 or None, got {host_tracer_level}")
    level = 1 if host_tracer_level is None else host_tracer_level
    card = torch.cuda.is_available()
    activities = ([] if level == 0 and card else [ProfilerActivity.CPU]) + ([ProfilerActivity.CUDA] if card else [])
    with profile(activities=activities, record_shapes=level >= 2, with_stack=level >= 3,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof


annotate = torch.profiler.record_function  # with tracing.annotate("predict"): ...


def _sync(tree) -> None:
    for dev in {leaf.device for leaf in tree_leaves(tree) if isinstance(leaf, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class Throughput:
    """Steps/s counter: ``start`` and ``rate`` wait for the devices that
    ``sync_on``'s tensors live on (a tensor or a tree of them), so the
    timed span holds the device's work, not only its enqueueing."""

    def __init__(self):
        self._t0 = None
        self._steps = 0

    def start(self, sync_on=None):
        if sync_on is not None:
            _sync(sync_on)
        self._t0 = time.perf_counter()
        self._steps = 0

    def add(self, n: int):
        self._steps += n

    def rate(self, sync_on=None) -> float:
        if self._t0 is None:
            raise RuntimeError("Throughput.rate() called before start()")
        if sync_on is not None:
            _sync(sync_on)
        dt = time.perf_counter() - self._t0
        return self._steps / dt if dt > 0 else float("inf")

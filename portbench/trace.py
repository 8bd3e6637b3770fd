"""What a traced window leaves for the per-layer metrics to read.

:func:`profiler` records the window with ``torch.profiler`` (host operators
and, on the card, its kernels, copies and sets). :class:`Context` holds
that trace with the harness's own records of the window (host-clock spans
around each driver call, the port's launch counters, the updates each tick
ran) and the arithmetic every reader shares: the union of device
intervals, device time by kernel name, the work stages' operations and
bytes, and the breakdown of the result line.
"""

from __future__ import annotations

import importlib.util
import json
import re
from functools import cached_property
from pathlib import Path

import numpy as np
import torch

BENCH = Path(__file__).resolve().parent
PORT_CSRC = BENCH.parent / "slam_uwv_kalman_filters_tpu_torch" / "csrc"
# the card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W):
# float32 outside the tensor cores, and HBM3 bandwidth
PEAKS = json.loads((BENCH / "work" / "peaks.json").read_text())
NAME_CHARS = 160  # a breakdown's names are cut here: a templated kernel's full name runs to a thousand


def profiler(on_card: bool):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    return profile(activities=acts)


def percentile(values, q: float) -> float:
    """The ``q``-th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def port_kernel_names() -> list:
    """Names of the port's hand-written kernels: every ``__global__``
    function of its ``csrc``."""
    names = set()
    for path in sorted(PORT_CSRC.glob("*.cu*")):
        text = re.sub(r"__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)", "", path.read_text())
        names |= set(re.findall(r"__global__\s+void\s+(\w+)\s*\(", text))
    return sorted(names)


def _union_s(starts: np.ndarray, ends: np.ndarray) -> float:
    order = np.argsort(starts)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in zip(starts[order], ends[order]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-9


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_work_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Context:
    """The traced window as the metric readers see it."""

    def __init__(self, *, cell: dict, ticks: int, window_s: float, host_ms: list, launches: dict, schedule: list,
                 prof, bank: int, dtype):
        self.cell, self.ticks, self.window_s = cell, ticks, window_s
        self.host_ms, self.launches, self.schedule = host_ms, launches, schedule
        self.bank, self.dtype = bank, dtype
        self.config, self.mix = cell["config"], cell["mix"]
        self._events = [] if prof is None else list(prof.profiler.kineto_results.events())

    @cached_property
    def device_events(self):
        """(names, start ns, end ns) of every device activity in the window."""
        ev = [e for e in self._events if e.device_type() == torch.autograd.DeviceType.CUDA]
        return ([e.name() for e in ev], np.array([e.start_ns() for e in ev], dtype=np.float64),
                np.array([e.start_ns() + e.duration_ns() for e in ev], dtype=np.float64))

    @cached_property
    def host_events(self):
        ev = [e for e in self._events if e.device_type() == torch.autograd.DeviceType.CPU]
        return ([e.name() for e in ev], np.array([e.start_ns() for e in ev], dtype=np.float64),
                np.array([e.start_ns() + e.duration_ns() for e in ev], dtype=np.float64))

    def busy_s(self) -> float:
        """Seconds in which some device activity ran (the union)."""
        _, s, e = self.device_events
        return _union_s(s, e)

    def device_s_matching(self, kernels) -> float:
        """Device seconds of the activities whose name holds one of
        ``kernels`` as a whole word."""
        names, s, e = self.device_events
        pats = [re.compile(rf"\b{re.escape(k)}\b") for k in kernels]
        return float(sum(e[i] - s[i] for i, n in enumerate(names) if any(p.search(n) for p in pats))) * 1e-9

    def device_s_total(self) -> float:
        _, s, e = self.device_events
        return float((e - s).sum()) * 1e-9

    # -- work stages --------------------------------------------------------

    @cached_property
    def stage_map(self) -> dict:
        """{stage: the kernels that do its work}, from ``work/kernels/<kernel>.json``."""
        out = {}
        for path in sorted((BENCH / "work" / "kernels").glob("*.json")):
            out.setdefault(json.loads(path.read_text())["stage"], []).append(path.stem)
        return out

    def stage(self, name: str):
        """The work module of stage ``name`` (``portbench/work/<name>.py``)."""
        return _load(BENCH / "work" / f"{name}.py")

    def roofline_pct(self, stage: str):
        """The stage's least time on the card over the device time of the
        kernels the map assigns to it, in percent; None where those
        kernels did not run in the window."""
        seconds = self.device_s_matching(self.stage_map.get(stage, []))
        if seconds <= 0.0:
            return None
        ops, nbytes = self.stage(stage).work(self)
        bound = max(ops / PEAKS["f32_ops_per_s"], nbytes / PEAKS["hbm_bytes_per_s"])
        return 100.0 * bound / seconds

    # -- breakdown -------------------------------------------------------------

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the ten
        longest idle gaps named by the host operation that overlapped each
        most (the shortest such, where several overlap alike)."""
        names, s, e = self.device_events
        if not names:
            return {"device_ops": [], "idle_gaps": []}
        by = {}
        for n, a, b in zip(names, s, e):
            n = n[:NAME_CHARS]
            by[n] = by.get(n, 0.0) + (b - a) * 1e-9
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        order = np.argsort(s)
        gaps, cur = [], e[order[0]]
        for i in order[1:]:
            if s[i] > cur:
                gaps.append((cur, s[i]))
            cur = max(cur, e[i])
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        hn, hs, he = self.host_events
        named = []
        for a, b in gaps:
            overlap = np.minimum(he, b) - np.maximum(hs, a)
            cands = np.nonzero(overlap > 0)[0]
            if len(cands):
                best = max(cands, key=lambda i: (overlap[i], -(he[i] - hs[i])))
                label = hn[best][:NAME_CHARS]
            else:
                label = "(no host operation)"
            named.append([label, (b - a) * 1e-9])
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}

"""The benchmark's harness: inputs from the seed, cells found by name, the
work counts, the contract's characters, the JAX check, and the comparison
failing under a broken program. CPU, at small banks; the tests marked
``cuda`` decide inside themselves whether a card is there."""

import json
import re
import subprocess
import sys

import pytest
import torch

from .helpers import ROOT, small_spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture
def cuda_device():
    """The card, or a skip where this machine has none (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control's TF32 products and the port's kernels run only there")
    return "cuda"


def _setup(cell: str, seed: int):
    from portbench import run as R

    return R.Setup(small_spec(cell, bank=8, stream_ticks=200), seed, "cpu")


def test_traffic_is_deterministic_per_seed():
    a, b, c = _setup(CELLS[1], 2**32 + 9), _setup(CELLS[1], 2**32 + 9), _setup(CELLS[1], 2**32 + 10)
    for name in a.streams:
        assert torch.equal(a.streams[name], b.streams[name]), name
        assert not torch.equal(a.streams[name], c.streams[name]), name
    assert torch.equal(a.ref_inputs.mu0, b.ref_inputs.mu0) and torch.equal(a.idx, b.idx)
    assert torch.equal(a.params.process_noise, b.params.process_noise)
    assert not torch.equal(a.ref_inputs.mu0, c.ref_inputs.mu0)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    from portbench import run as R

    spec = R.load_cell(cell)
    assert spec["cell"]["name"] == cell
    assert (ROOT / "portbench" / "gen" / f"{spec['mix']['generator']}.py").exists()
    for m in spec["per_layer"]:
        assert hasattr(R.load_module(ROOT / "portbench" / "metrics" / f"{m['name']}.py"), "read"), m["name"]
    assert set(spec["check"]["limits"]) and spec["check"]["sample"] > 0
    assert {"filter", "vehicle", "bank", "dtype"} <= set(spec["config"])
    assert spec["mix"]["updates"]


MIXES = sorted({w["traffic"] for w in BENCH["workloads"]})


@pytest.mark.parametrize("mix", MIXES)
def test_mix_declares_what_each_update_reads_and_reports(mix):
    """Each update of a mix names the ``PoseInputs`` fields it fills, from
    its reading, covariance, mask or a constant of the mix, a measurement
    model of the reference that exists, and the ``TickOutput`` fields that
    report it; the judge's gate sits on the gated models alone."""
    from portbench.reference import replay
    from portbench.reference.models import load
    from slam_uwv_kalman_filters_tpu_torch.models import pose_driver as drv

    spec = json.loads((ROOT / "portbench" / "traffic" / f"{mix}.json").read_text())
    sources = {"reading", "cov", "valid"} | set(spec.get("constants", {}))
    seen = set()
    for u in spec["updates"]:
        assert set(u["fields"]) <= set(drv.PoseInputs._fields) and set(u["fields"].values()) <= sources, u
        assert not (set(u["fields"]) & seen), u  # a field is filled by one update
        seen |= set(u["fields"])
        assert callable(load(u["model"]).h) and len(u["meas_var"]) >= 1 and 0 <= u["at"] < u["every"]
        assert set(u.get("outputs", {}).values()) <= set(drv.TickOutput._fields), u
        assert u.get("aux") is None or u["aux"] in spec["constants"]
    gated = [u["stream"] for u in replay._gated(spec["updates"])]
    assert gated == [u["stream"] for u in spec["updates"] if "accepted" in u.get("outputs", {})]


@pytest.mark.parametrize("cell", CELLS)
def test_window_records_only_what_the_limits_read(cell):
    """The window gathers the per-tick outputs that the cell's compared
    numbers read, and no other."""
    from portbench import run as R
    from portbench.reference import replay

    spec = R.load_cell(cell)
    fields = replay.tick_fields(spec["check"]["limits"], spec["mix"]["updates"])
    expect = {"adcp_accepted"} | ({"cov_trace"} if any(k.startswith("trace_rel") for k in spec["check"]["limits"])
                                  else set())
    assert set(fields) == expect
    every = replay.tick_fields(replay.all_numbers(spec["mix"]["updates"]), spec["mix"]["updates"])
    assert set(every) == {"position", "orientation", "velocity", "cov_trace", "dvl_nis", "adcp_accepted"}


def test_operation_counter_counts_the_formulas():
    """The counter reads a formula's operations: a quaternion product is 16
    products and 12 sums, a cross product 9 a vector, a 3×3 matrix on a
    vector 18; copies count nothing."""
    from portbench.reference import pose_ukf as ref
    from portbench.work.common import count_ops

    a = torch.randn(1, 4, dtype=torch.float64)
    assert count_ops(ref.qmul, a, a)[0] == 28.0
    v = torch.randn(5, 3, dtype=torch.float64)
    assert count_ops(torch.linalg.cross, v, v)[0] == 45.0
    assert count_ops(torch.matmul, torch.eye(3, dtype=torch.float64), v[0])[0] == 18.0
    assert count_ops(lambda x: torch.cat([x, x]).clone(), v)[0] == 0.0


class _Ctx:
    """Just what the work stages and ``roofline_pct`` read."""

    def __init__(self, cell: str, kernel: str, seconds: float):
        from portbench import trace as tr
        from portbench import run as R

        spec = R.load_cell(cell)
        self.config, self.mix, self.bank, self.dtype, self.ticks = spec["config"], spec["mix"], 131072, \
            torch.float32, 200
        self.schedule = [("acceleration",)] * 180 + [("acceleration", "velocity", "body_efforts")] * 20
        self._names = [kernel + "<float>(float*)"] * 4
        self._seconds = seconds
        self.stage = tr.Context.stage.__get__(self)
        self.roofline_pct = tr.Context.roofline_pct.__get__(self)
        self.device_s_matching = tr.Context.device_s_matching.__get__(self)

    @property
    def device_events(self):
        import numpy as np

        s = np.arange(4) * 1e9
        return self._names, s, s + self._seconds / 4 * 1e9


@pytest.mark.parametrize("stage", ["predict", "update"])
def test_work_count_does_not_depend_on_kernel_names(stage):
    """The work of a stage comes from the cell's shapes; the map only says
    whose time it is divided by, so a renamed kernel reads the same share."""
    shares = []
    for kernel in ("pose_stage_kernel_a", "fused_stage_kernel_b"):
        ctx = _Ctx(CELLS[0], kernel, 0.8)
        ctx.stage_map = {stage: [kernel]}
        ops, nbytes = ctx.stage(stage).work(ctx)
        assert ops > 0 and nbytes > 0
        shares.append((ops, nbytes, ctx.roofline_pct(stage)))
    assert shares[0] == shares[1]
    assert 0.0 < shares[0][2] < 100.0
    ctx.stage_map = {stage: ["a_kernel_that_did_not_run"]}
    assert ctx.roofline_pct(stage) is None


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in BENCH["end_to_end"]] \
        + [m["name"] for m in BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["traffic"]) and 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"] and len(m["layer"]) <= 200
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_no_jax_in_a_run():
    """A whole (small, CPU) run loads neither JAX nor the JAX package; the
    check compares whole top-level names, so the port's own name passes."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.tests.helpers import small_spec\n"
        "from portbench import run as R\n"
        "res = R.run(small_spec('pose_montecarlo.survey_aided', bank=4, stream_ticks=200), 7, 1e9, False, 'cpu',"
        " max_ticks=5)\n"
        "assert 'slam_uwv_kalman_filters_tpu_torch' in sys.modules\n"
        "print(R.forbidden_modules())\n" % str(ROOT)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import run as R

    monkeypatch.setitem(sys.modules, "slam_uwv_kalman_filters_tpu_torch_extra", sys)
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert R.forbidden_modules() == ["jax"]


# -- the comparison fails under a broken program -----------------------------


def _unchanged_predict(monkeypatch):
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf

    monkeypatch.setattr(pf, "predict_lanes", lambda ls, params, dt, banked_ops=None: ls)


def _unchanged_update(monkeypatch):
    from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf

    real = puf.update_model_lanes
    monkeypatch.setattr(puf, "update_model_lanes", lambda model, ls, *a, **k: (ls, real(model, ls, *a, **k)[1]))


def _half_the_bank(monkeypatch):
    """Every in-kernel update reaches only the first half of the bank."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf

    real = puf.update_model_lanes

    def half(model, ls, *a, **k):
        new, info = real(model, ls, *a, **k)
        h = ls.cov_t.shape[-1] // 2
        return new._replace(cov_t=torch.cat([new.cov_t[..., :h], ls.cov_t[..., h:]], -1),
                            mu_t=torch.cat([new.mu_t[..., :h], ls.mu_t[..., h:]], -1)), info

    monkeypatch.setattr(puf, "update_model_lanes", half)


def _altered_answer(monkeypatch):
    """One vehicle's covariance, as the predict produces it, 1% larger."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf

    real = pf.predict_lanes

    def altered(ls, params, dt, banked_ops=None):
        out = real(ls, params, dt, banked_ops=banked_ops)
        cov = out.cov_t.clone()
        cov[..., 1] *= 1.01
        return out._replace(cov_t=cov)

    monkeypatch.setattr(pf, "predict_lanes", altered)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, _unchanged_predict, _unchanged_update, _half_the_bank, _altered_answer],
                         ids=["sound", "unchanged_predict", "unchanged_update", "half_the_bank", "altered_answer"])
def test_broken_program_is_not_correct(fault, cell, monkeypatch):
    """The whole run past the card check, on the port's plain path at a
    small bank (float64, every vehicle sampled), judged by the cell's own
    limits: sound it is correct, broken underneath it is not."""
    from portbench import run as R

    if fault is not None:
        fault(monkeypatch)
    spec = small_spec(cell)
    res = R.run(spec, 2**31 + 77, 1e9, False, "cpu", max_ticks=150)
    line = R.result_line(spec, res, False, "cpu")
    assert line["correct"] is (fault is None), line["checks"]
    assert list(line)[-1] == "checks"


def test_metric_readers_run_on_a_traced_cpu_window():
    """Every per-layer reader reads a traced window or returns nothing; on
    the CPU there are no device events, so the device readers return
    nothing and the host ones a number."""
    from portbench import run as R

    spec = small_spec("pose_montecarlo.survey_aided", bank=4, stream_ticks=200)
    res = R.run(spec, 11, 1e9, True, "cpu", max_ticks=3)
    line = R.result_line(spec, res, True, "cpu")
    assert set(line["metrics"]) == {"driver_host_ms_per_tick"}
    assert line["device"]["busy_s"] == 0.0 and line["breakdown"] == {"device_ops": [], "idle_gaps": []}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell, cuda_device):
    """The control (the reference in float32 with TF32 products) in the
    program's place fails the cell's limits: 256 vehicles over as many
    ticks as the cell's runs make (those its limits were read at)."""
    from portbench import calibrate as C
    from portbench import run as R
    from portbench.reference import replay

    spec = R.load_cell(cell)
    spec["check"]["sample"] = 256
    rec = C.control(spec, 2**31 + 1234, spec["check"]["readings"]["ticks"], cuda_device)
    assert not replay.passes(rec, spec["check"]["limits"]), rec


@pytest.mark.cuda
def test_a_short_run_is_correct_on_the_card(cuda_device):
    from portbench import run as R

    spec = small_spec("pose_montecarlo.survey_aided", bank=4096, dtype="float32", stream_ticks=400)
    spec["check"]["sample"] = 256
    res = R.run(spec, 2**31 + 99, 1e9, False, cuda_device, max_ticks=200)
    line = R.result_line(spec, res, False, cuda_device)
    assert line["correct"], line["checks"]


def test_each_mapped_kernel_is_a_port_kernel_of_a_stage_with_work():
    from portbench import trace as tr

    stages = {}
    for path in sorted((ROOT / "portbench" / "work" / "kernels").glob("*.json")):
        stage = json.loads(path.read_text())["stage"]
        assert path.stem in tr.port_kernel_names(), path.stem
        assert (ROOT / "portbench" / "work" / f"{stage}.py").exists(), stage
        stages.setdefault(stage, []).append(path.stem)
    assert set(stages) == {"predict", "update"}

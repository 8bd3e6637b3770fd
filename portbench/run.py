"""The benchmark of the PyTorch/CUDA port: one cell, one run, one result line.

    python -m portbench.run --workload pose_fleet.survey_aided --seed 7 --seconds 30 --trace 0

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: it names a
configuration (``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<mix>.json``, made by ``portbench/gen/<generator>.py``).
Set-up makes the bank, the parameter draw and every vehicle's sensor
streams on the card from ``--seed``, builds the port's state and parameters
from them, and runs one period of the mix's schedule (the first run in a
checkout builds the port's kernels there). The window then drives
``pose_driver.pose_step_bank_lanes`` once a tick, closed loop, for
``--seconds``, and a ``synchronize`` ends it. ``--trace 0`` reports the
cell's end-to-end metrics; ``--trace 1`` runs the window under
``torch.profiler`` and reports the per-layer metrics, each read by
``portbench/metrics/<metric>.py``. Once the window has closed, the plain
reference (``portbench/reference``) replays a sample of the vehicles drawn
from the seed and judges what the window produced; each number it compares
is printed beside its limit, on standard error and under ``checks`` in the
result line, which is the last line of standard output.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
# every cache a run may fill sits at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)

import torch  # noqa: E402

from portbench import trace as tr  # noqa: E402
from portbench.reference import pose_ukf as ref  # noqa: E402
from portbench.reference import replay  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "slam_uwv_kalman_filters_tpu")
MAX_TICKS = 4096  # a window ends here if its clock has not ended it first


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_file_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, bench_file: Path = ROOT / "BENCHMARK.json") -> dict:
    """The cell's entry, configuration, traffic mix and metrics, by name."""
    bench = json.loads(bench_file.read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in {bench_file}")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    applies = lambda m: name in m.get("workloads", [name])
    return {"cell": cell, "config": config, "mix": mix,
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)],
            "check": json.loads((BENCH / "checks" / f"{name}.json").read_text())}


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# set-up: inputs from the seed, the port's state and parameters from them
# ---------------------------------------------------------------------------


def port_params(config: dict, mix: dict, dtype, device, draw):
    """The port's parameters, built by its own constructors from the
    configuration, cast to ``dtype``; with a draw, banked per vehicle as the
    fleet harness banks them."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_ukf as pukf
    from slam_uwv_kalman_filters_tpu_torch.ops import dynamics as dyn
    from slam_uwv_kalman_filters_tpu_torch.parallel.bank import tree_map
    from slam_uwv_kalman_filters_tpu_torch.utils.config import config_from_dict

    f64 = torch.float64
    v = config["vehicle"]
    t = lambda x: torch.as_tensor(x, dtype=f64, device=device)
    uwv = dyn.UWVParameters(torch.diag(t(v["inertia_diag"])), torch.diag(t(v["lin_damping_diag"])),
                            torch.diag(t(v["quad_damping_diag"])), t(v["weight"]), t(v["buoyancy"]),
                            t(v["cog"]), t(v["cob"]))
    eye = torch.eye(3, dtype=f64, device=device)
    _, params = pukf.init_from_pose(torch.zeros(3, dtype=f64, device=device), eye, t([1.0, 0.0, 0.0, 0.0]), eye,
                                    config_from_dict(config["filter"]), uwv, imu_delta_t=mix["dt"], dtype=f64,
                                    device=device)
    params = tree_map(lambda a: a.to(dtype), params)
    if draw is None:
        return params
    nb = draw["scale"].shape[0]
    bp = tree_map(lambda x: x.expand(nb, *x.shape), params)
    return bp._replace(
        process_noise=bp.process_noise * draw["scale"][:, None, None],
        water_velocity_scale=bp.water_velocity_scale * draw["scale"],
        atmospheric_pressure=bp.atmospheric_pressure + draw["p_atm_offset"],
        model=bp.model._replace(inertia_matrix=bp.model.inertia_matrix * draw["inertia_scale"][:, None, None]),
    )


def port_state(mu, cov, dtype):
    """The port's bank-first state from (B, 54) storage means and a
    (53, 53) covariance shared by the bank."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_ukf as pukf

    nb = mu.shape[0]
    mat = lambda sl: mu[:, sl].reshape(nb, 3, 3).transpose(1, 2)
    s = pukf.PoseState(position=mu[:, ref.POS], orientation=mu[:, ref.QUAT], velocity=mu[:, ref.VEL],
                       acceleration=mu[:, ref.ACC], bias_gyro=mu[:, ref.BG], bias_acc=mu[:, ref.BA],
                       gravity=mu[:, ref.GRAV], inertia=mat(ref.INERTIA), lin_damping=mat(ref.LIN_D),
                       quad_damping=mat(ref.QUAD_D), water_velocity=mu[:, ref.WV],
                       water_velocity_below=mu[:, ref.WVB], bias_adcp=mu[:, ref.BADCP], water_density=mu[:, ref.RHO])
    return pukf.PoseUKFState(mu=s, cov=cov.to(dtype).expand(nb, ref.N, ref.N),
                             rotation_rate=torch.zeros(nb, 3, dtype=dtype, device=mu.device))


class Setup:
    """Everything a window needs, built from the seed."""

    def __init__(self, spec: dict, seed: int, device, port: bool = True):
        config, mix = spec["config"], spec["mix"]
        self.mix = mix
        dtype = {"float32": torch.float32, "float64": torch.float64}[config["dtype"]]
        self.dtype, self.bank = dtype, config["bank"]
        gen_mod = load_module(BENCH / "gen" / f"{mix['generator']}.py")
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        truth = gen_mod.simulate_truth(mix, config["filter"], config["vehicle"])
        # the program's precision rounds every input once; both sides read the rounded values
        mu0, cov0 = gen_mod.make_start(mix, config["filter"], config["vehicle"], truth, self.bank, gen, device)
        mu0, cov0 = mu0.to(dtype), cov0.to(dtype)
        draw = None
        if config.get("draw"):
            draw = {k: v.to(dtype) for k, v in gen_mod.make_draw(config["draw"], self.bank, gen, device).items()}
        self.streams = gen_mod.make_streams(mix, truth, self.bank, gen, dtype, device)
        covs = {k: v.to(dtype=dtype, device=device) for k, v in gen_mod.measurement_covs(mix).items()}
        consts = {k: torch.full((self.bank,), v, dtype=dtype, device=device)
                  for k, v in mix.get("constants", {}).items()}
        sample = min(spec["check"]["sample"], self.bank)
        self.idx = torch.randperm(self.bank, generator=gen, device=device)[:sample].sort().values
        self.ref_inputs = replay.sample_inputs(mu0, cov0, self.streams, covs, consts, mix, self.idx)
        self.draw_sample = None if draw is None else {k: v[self.idx] for k, v in draw.items()}
        self.ref_params = ref.make_params(config["filter"], config["vehicle"], mix["dt"], torch.float64, device,
                                          self.draw_sample)
        self.gen_mod = gen_mod
        if not port:  # the reference's inputs alone
            del self.streams
            return

        from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf

        self.params = port_params(config, mix, dtype, device, draw)
        self.banked_ops = None if draw is None else pf.banked_predict_operands(self.params, mix["dt"], dtype)
        self.lanes = pf.to_lanes(port_state(mu0, cov0, dtype))
        del mu0
        b = self.bank
        self.static = {"dt": torch.full((b,), mix["dt"], dtype=dtype, device=device),
                       "valid": torch.ones(b, dtype=torch.bool, device=device), **consts}
        self.covs = {k: v.expand(b, *v.shape) for k, v in covs.items()}
        self.period = self.streams["gyro"].shape[0]

    def inputs(self, g: int):
        """``pose_driver.PoseInputs`` of tick ``g``: each update of the mix
        fills the fields it names on the ticks it fires (its reading, its
        covariance, a mask valid for every vehicle, a per-vehicle constant),
        and every other field is None."""
        from slam_uwv_kalman_filters_tpu_torch.models import pose_driver as drv

        j = g % self.period
        fields = dict.fromkeys(drv.PoseInputs._fields)
        fields.update(dt=self.static["dt"], rotation_rate=self.streams["gyro"][j])
        for u in self.mix["updates"]:
            k = self.gen_mod.fires(u, j)
            if k is None:
                continue
            src = {"reading": self.streams[u["stream"]][k], "cov": self.covs[u["stream"]]}
            fields.update({f: src[v] if v in src else self.static[v] for f, v in u["fields"].items()})
        return drv.PoseInputs(**fields)

    def updates(self, g: int) -> tuple:
        """Models of the updates tick ``g`` runs, in the program's order."""
        j = g % self.period
        return tuple(u["model"] for u in self.mix["updates"] if self.gen_mod.fires(u, j) is not None)


class Recorder:
    """The sampled vehicles' per-tick outputs that the judge reads (the
    fields ``replay.tick_fields`` names), gathered tick by tick into buffers
    allocated in set-up."""

    def __init__(self, fields, idx, ticks: int):
        self.fields, self.idx, self.ticks = fields, idx, ticks
        self.bufs = {}

    def record(self, g: int, out) -> None:
        for n in self.fields:
            v = getattr(out, n)
            if n not in self.bufs:  # the warm-up's first tick allocates
                self.bufs[n] = torch.zeros((self.ticks, self.idx.shape[0]) + v.shape[1:], dtype=v.dtype,
                                            device=v.device)
            torch.index_select(v, 0, self.idx, out=self.bufs[n][g])

    def outputs(self, ticks: int, ls) -> replay.Outputs:
        """The recorded outputs and the sampled vehicles' final state."""
        mu, cov = replay.decode_lanes(ls.cov_t.index_select(2, self.idx), ls.mu_t.index_select(1, self.idx))
        return replay.Outputs({n: b[:ticks] for n, b in self.bufs.items()}, mu=mu, cov=cov)


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def run(spec: dict, seed: int, seconds: float, trace: bool, device, max_ticks: int = MAX_TICKS,
        numbers=None) -> dict:
    """Set up, warm, measure, judge; returns the result line's fields. The
    window ends after ``seconds`` or ``max_ticks`` ticks, whichever comes
    first. The window records the per-tick outputs that ``numbers`` (the
    cell's limited numbers where None) read."""
    from slam_uwv_kalman_filters_tpu_torch.models import pose_driver as drv
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    su = Setup(spec, seed, device)
    warm = spec["mix"]["period"]
    numbers = spec["check"]["limits"] if numbers is None else numbers
    rec = Recorder(replay.tick_fields(numbers, spec["mix"]["updates"]), su.idx, warm + max_ticks)
    ls = su.lanes
    del su.lanes
    step = lambda ls, g: drv.pose_step_bank_lanes(ls, su.params, su.inputs(g), banked_ops=su.banked_ops)
    for g in range(warm):  # one period of the schedule: every shape the window uses
        ls, out = step(ls, g)
        rec.record(g, out)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(max_ticks + 1)] if on_card else None
    host_ms, stamps = [], []
    sync()
    setup_s = time.perf_counter() - T_START
    cuda_lib.reset_launch_counts()
    prof = tr.profiler(on_card) if trace else None
    if prof is not None:
        prof.__enter__()
    t0 = time.perf_counter()
    if events:
        events[0].record()
    ticks = 0
    while ticks < max_ticks and time.perf_counter() - t0 < seconds:
        g = warm + ticks
        h0 = time.perf_counter()
        ls, out = step(ls, g)
        host_ms.append(1e3 * (time.perf_counter() - h0))
        rec.record(g, out)
        ticks += 1
        if events:
            events[ticks].record()
        else:
            stamps.append(time.perf_counter())
    sync()
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    launches = {k: v.launches for k, v in cuda_lib.KERNELS.items() if v.launches}
    if events:
        tick_ms = [events[i].elapsed_time(events[i + 1]) for i in range(ticks)]
    else:
        tick_ms = [1e3 * (b - a) for a, b in zip([t0] + stamps[:-1], stamps)]
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    total = warm + ticks
    # the program's final state: every vehicle checked for a finite state, the sample read for the judge
    finite = torch.isfinite(ls.mu_t).all(0) & torch.isfinite(torch.diagonal(ls.cov_t, dim1=0, dim2=1)).all(-1) \
        & (torch.diagonal(ls.cov_t, dim1=0, dim2=1) > 0).all(-1)
    lost = int((~finite).sum())
    prog = rec.outputs(total, ls)
    schedule = [su.updates(warm + k) for k in range(ticks)]
    ctx = tr.Context(cell=spec, ticks=ticks, window_s=window_s, host_ms=host_ms, launches=launches,
                     schedule=schedule, prof=prof, bank=su.bank, dtype=su.dtype)
    ref_inputs, ref_params, period = su.ref_inputs, su.ref_params, su.period
    del ls, out, su, step, rec
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    verdict = replay.judge(ref_inputs, ref_params, total, prog)
    verdict.info["judge_s"] = time.perf_counter() - t_judge
    return {"ticks": ticks, "period": period, "window_s": window_s, "setup_s": setup_s, "tick_ms": tick_ms,
            "lost": lost, "memory_peak": memory_peak, "ctx": ctx, "verdict": verdict}


def result_line(spec: dict, res: dict, trace: bool, device) -> dict:
    """The result line's object, with the compared numbers last."""
    limits = spec["check"]["limits"]
    numbers = res["verdict"].numbers
    correct = replay.passes(numbers, limits) and res["lost"] == 0
    bank, ticks = spec["config"]["bank"], res["ticks"]
    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": res["memory_peak"]}
    line = {"correct": correct, "attempted": bank * ticks, "failed": res["lost"] * ticks}
    if trace:
        ctx = res["ctx"]
        metrics = {}
        for m in spec["per_layer"]:
            value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=ctx.busy_s(), window_s=res["window_s"])
        line.update(metrics=metrics, device=dev, breakdown=ctx.breakdown())
    else:
        values = {"ticks_per_s": bank * ticks / res["window_s"], "setup_s": res["setup_s"],
                  "tick_ms_p95": tr.percentile(res["tick_ms"], 95.0)}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in spec["end_to_end"]}
        line.update(metrics=metrics, device=dev)
    line["checks"] = {**replay.number_line(numbers, limits),
                      "vehicles_lost": {"value": res["lost"], "limit": 0}}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("portbench: no CUDA device; this benchmark measures the port on the card", file=sys.stderr)
        return 2
    spec = load_cell(args.workload)
    if torch.cuda.device_count() < spec["cell"]["chips"]:
        print(f"portbench: {args.workload} needs {spec['cell']['chips']} cards", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    res = run(spec, args.seed, args.seconds, bool(args.trace), "cuda")
    line = result_line(spec, res, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; the benchmark may load neither JAX nor the JAX package",
              file=sys.stderr)
        return 3
    info = res["verdict"].info
    if info["ticks"] > res["period"]:
        print(f"portbench: the window outran the {res['period']} ticks of streams made in set-up; they were "
              "replayed from their start, the filter state carried on", file=sys.stderr)
    print(f"portbench: {args.workload} seed={args.seed} ticks={res['ticks']} window_s={res['window_s']:.6f} "
          f"setup_s={res['setup_s']:.6f} sample={info['sample']} judged_ticks={info['ticks']} "
          f"gate_followed={info['gate_followed']} judge_s={info['judge_s']:.3f}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that the limits of ``portbench/checks/<cell>.json`` are set
from: the program's compared numbers over several seeds, and the control's.

    python -m portbench.calibrate --workload pose_fleet.survey_aided --seconds 20 \\
        --seeds 11,12,13 --control-seeds 21,22,23 [--out calibration.jsonl]

For each of ``--seeds`` it makes a whole run of the cell (set-up, warm-up,
the window, the judge) and prints its numbers. For each of
``--control-seeds`` it builds the same inputs and puts the control in the
program's place: the plain reference in float32 with TF32 products on, the
step a later change might take, over as many ticks as the program's runs
made (the median), judged by the same float64 replay. The benchmark's own
runs never run this. One JSON line per reading.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from portbench import run as R
from portbench.reference import pose_ukf as ref
from portbench.reference import replay


def control(spec: dict, seed: int, ticks: int, device="cuda") -> dict:
    """The control's numbers on the inputs of ``seed`` over ``ticks`` ticks."""
    su = R.Setup(spec, seed, device, port=False)
    inp = su.ref_inputs
    draw = su.draw_sample
    params32 = ref.make_params(spec["config"]["filter"], spec["config"]["vehicle"], spec["mix"]["dt"],
                               torch.float32, device, draw)
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = replay.replay(inp, params32, ticks, torch.float32, 1e-6)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep
    verdict = replay.judge(inp, su.ref_params, ticks, out)
    return {"kind": "control", "seed": seed, "ticks": ticks, **verdict.numbers, **verdict.info}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--ticks", type=int, default=0, help="control ticks where no program run sets them")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    spec = R.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = [int(s) for s in args.control_seeds.split(",") if s]
    sink = open(args.out, "a") if args.out else None

    def emit(rec):
        rec = {"workload": args.workload, **rec}
        print(json.dumps(rec), flush=True)
        if sink:
            sink.write(json.dumps(rec) + "\n")
            sink.flush()

    ticks = []
    for seed in seeds:
        t0 = time.perf_counter()
        res = R.run(spec, seed, args.seconds, False, "cuda", numbers=replay.all_numbers(spec["mix"]["updates"]))
        ticks.append(res["verdict"].info["ticks"])
        emit({"kind": "program", "seed": seed, **res["verdict"].numbers, **res["verdict"].info,
              "lost": res["lost"], "window_ticks": res["ticks"], "setup_s": res["setup_s"],
              "ticks_per_s": spec["config"]["bank"] * res["ticks"] / res["window_s"],
              "tick_ms_p95": R.tr.percentile(res["tick_ms"], 95.0), "seconds": time.perf_counter() - t0})
        del res
        torch.cuda.empty_cache()
    n = int(statistics.median(ticks)) if ticks else args.ticks
    for seed in ctl:
        t0 = time.perf_counter()
        emit({**control(spec, seed, n), "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where K2's time goes, on the card: the fused predict cut after each stage.

Builds copies of the package under ``build/k2_stages/`` whose warp body
(``csrc/warp_predict.cuh``) returns before its stage 2 (the block's loads
and the factor only), 3 (+ the sigma points), 4 (+ the quaternion mean) and
5 (+ the flat means and deviations), beside the whole kernel; times K2 in
shared mode at bank 131 072, float32, from each copy in a process of its own
(``tools/pose_step_times.py``; the whole kernel first and last, for the
spread), and prints one JSON line: each cut's milliseconds and the
difference to the cut before, the time of each stage. One more copy keeps
every stage but writes the reconstruct's outputs to one shared-memory word a
lane (a volatile store, so that no output's arithmetic is dropped) instead
of global memory: the whole kernel's time less its time is what the
direct, one-entry-a-lane stores of the output cost. A cut kernel's outputs
are garbage; only its time is read. It needs a card; it builds nothing at
import::

    python -m slam_uwv_kalman_filters_tpu_torch.tools.k2_stages
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
# each cut: the line of warp_predict.cuh that the early return goes before
CUTS = {
    "factor": "  // 2. boxplus + process model",
    "points": "  // 3. the quaternion mean",
    "karcher": "  // 4. each flat storage row",
    "flats": "  // 5. the per-instance Q pieces",
}
STORE = "co[(static_cast<long long>(cc) * N + r) * nb] = val;"


def main() -> int:
    root = PACKAGE.parent
    roots = {"whole": root}
    patches = {cut: (marker, "  return;  // cut for tools/k2_stages.py\n" + marker) for cut, marker in CUTS.items()}
    patches["no_store"] = (STORE, "*reinterpret_cast<volatile T*>(s + t.terms + lane) = val;  // for tools/k2_stages.py")
    for cut, (old, new) in patches.items():
        copy = root / "build" / "k2_stages" / cut
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(PACKAGE, copy / PACKAGE.name, ignore=shutil.ignore_patterns("__pycache__"))
        src = copy / PACKAGE.name / "csrc" / "warp_predict.cuh"
        text = src.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{src}: {old!r} is not there once")
        src.write_text(text.replace(old, new))
        roots[cut] = copy
    build = "from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib; cuda_lib.library()"
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=r) for r in roots.values()]
    if any(p.wait() for p in procs):
        return 1
    ms = {}
    for label in ("whole", *CUTS, "no_store", "whole"):
        run = subprocess.run([sys.executable, "-m", "slam_uwv_kalman_filters_tpu_torch.tools.pose_step_times",
                              "--banks", "131072", "--kernels", "pose_predict"],
                             cwd=roots[label], capture_output=True, text=True)
        if run.returncode:
            print(run.stdout[-2000:], run.stderr[-4000:], file=sys.stderr)
            return 1
        out = json.loads(run.stdout.strip().splitlines()[-1])
        ms.setdefault(label, []).append(out["times"][0]["ms"])
        print(f"K2 shared, bank 131072, float32, up to {label}: {ms[label][-1]:.3f} ms", flush=True)
    order = list(CUTS) + ["whole"]
    stages = {name: ms[name][0] - (ms[order[i - 1]][0] if i else 0.0) for i, name in enumerate(order)}
    stages["reconstruct"] = stages.pop("whole")
    stages["of_which_direct_stores"] = ms["whole"][0] - ms["no_store"][0]
    print(json.dumps({"card": out["card"], "ms_up_to": ms, "stage_ms": stages}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time K7 (the BottomUKF step: predict + one range) and K10 (the
IndirectPoseUKF marker update, 1 and 4 corners) alone on the card: an
earlier checkout's kernels, the current kernels (the design they pick for
the bank), and each of the current kernels' two designs at every bank, in
one process.

This module also defines the two small-filter banks that ``chip_smoke.py``
drives (bench.py's small-filter configurations): :func:`bottom_bank` and
:func:`indirect_bank`. The operands timed here are recorded from one step of
those banks' own entry points at each bank: for K7 the step predict(0.1) +
one range beam (0, 0, −1) from the origin, z = 0.3, R = 1e-3; for K10 the
marker update after predict(0.1), the bank's corner (0.1, 0.1, 0) at pixel
(330, 236) and, for 4 corners, three more at ±0.1 m around it 20 px apart.

``--parent DIR`` builds ``DIR/slam_uwv_kalman_filters_tpu_torch/csrc/
{bottom_step,indirect_markers}.cu`` (the same C interface) with ``nvcc``.
The two designs are the current sources built with the banks at which they
switch (``SLAM_BOTTOM_GROUP_BANKS``, ``SLAM_INDIRECT_WIDE_BANKS``) at their
largest ("small-bank design": K7's group of 8 lanes, K10's 32) and at 0
("large-bank design": K7's one thread, K10's 4 lanes). All launches go
through the same wrappers. Each time is the median of three rounds of CUDA
events over ``--reps`` launches held behind a spin kernel of ``--hold``
cycles a launch, so the host's time to enqueue each launch is hidden. The
order is parent, current, small-bank design, large-bank design, current,
parent. Prints one JSON line: the card's name and power limit
(``nvidia-smi``), then per kernel, bank and build the milliseconds a launch.

    python -m slam_uwv_kalman_filters_tpu_torch.tools.small_kernel_times --parent build/parent \\
        --banks 1 256 4096 8192 16384 65536
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import torch

from slam_uwv_kalman_filters_tpu_torch.models import bottom_fused as bf
from slam_uwv_kalman_filters_tpu_torch.models import bottom_ukf as bu
from slam_uwv_kalman_filters_tpu_torch.models import indirect_fused as ifu
from slam_uwv_kalman_filters_tpu_torch.models import indirect_pose_ukf as ipu
from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
from slam_uwv_kalman_filters_tpu_torch.parallel import bank
from slam_uwv_kalman_filters_tpu_torch.tools.pose_step_times import device_ms
from slam_uwv_kalman_filters_tpu_torch.utils.config import CameraConfiguration

SOURCES = ("bottom_step.cu", "indirect_markers.cu")
SWITCHES = ("SLAM_BOTTOM_GROUP_BANKS", "SLAM_INDIRECT_WIDE_BANKS")
DESIGNS = {"small-bank design": 1 << 62, "large-bank design": 0}  # the banks at which both kernels switch


def bottom_bank(nb: int, dtype, device):
    """bench.py's small-filter BottomUKF (BASELINE configs[1]) at bank
    ``nb``: distance 10 m, normal (0, 0, 1), cov diag(1, 0.05, 0.05),
    velocity (0.5, 0, −0.1), the reference's identity process noise. Returns
    (bank state, lanes state, step): the step is predict(0.1) + one range
    beam (0, 0, −1) from the origin, z = 0.3, R = 1e-3, one K7 launch."""
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)
    state, params = bu.init(bu.BottomState(distance=t([10.0]), normal=t([0.0, 0.0, 1.0])),
                            torch.diag(t([1.0, 0.05, 0.05])))
    bs = bank.replicate(bu.set_velocity(state, t([0.5, 0.0, -0.1])), nb)
    up = [bf.StepUpdate("range", t([0.3]).expand(nb, 1), t([[1e-3]]), t([0.0, 0.0, -1.0]),
                        torch.zeros(3, dtype=dtype, device=device))]
    return bs, bf.to_lanes(bs), lambda ls: bf.step_lanes(ls, params, 0.1, up)[0]


def indirect_bank(nb: int, dtype, device, corners: int = 1):
    """bench.py's IndirectPoseUKF (BASELINE configs[2]: ``init((0.05,)*3,
    (0.02,)*3, 30)``) at bank ``nb``. Returns (bank state, lanes state,
    step): the step is predict(0.1), then the marker update of one corner
    (pixel (330, 236) with covariance 4·I of the feature (0.1, 0.1, 0) of a
    marker at (2, 0, 1) with identity orientation and pose covariance
    1e-4·I, the camera at the body origin, a default camera), one K9 and one
    K10 launch; ``corners`` = 4 adds three corners at ±0.1 m 20 px apart."""
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)
    state, params = ipu.init((0.05,) * 3, (0.02,) * 3, 30.0, dtype=dtype, device=device)
    bs = bank.replicate(state, nb)
    px = t([[330.0, 236.0], [310.0, 236.0], [310.0, 256.0], [330.0, 256.0]][:corners])
    feats = t([[0.1, 0.1, 0.0], [-0.1, 0.1, 0.0], [-0.1, -0.1, 0.0], [0.1, -0.1, 0.0]][:corners])
    marker = (px, 4.0 * torch.eye(2, dtype=dtype, device=device).expand(corners, 2, 2), feats, t([2.0, 0.0, 1.0]),
              t([1.0, 0.0, 0.0, 0.0]), 1e-4 * torch.eye(6, dtype=dtype, device=device), CameraConfiguration(),
              torch.zeros(3, dtype=dtype, device=device), t([1.0, 0.0, 0.0, 0.0]))

    def step(ls):
        return ifu.update_markers_lanes(ifu.predict_lanes(ls, params, 0.1), *marker)[0]

    return bs, ifu.to_lanes(bs), step


def _recorded(module, name: str, run) -> tuple:
    """The arguments of ``module.name``'s call while ``run()`` runs."""
    seen, fn = [], getattr(module, name)

    def wrapped(*args):
        seen.append(args)
        return fn(*args)

    setattr(module, name, wrapped)
    try:
        run()
    finally:
        setattr(module, name, fn)
    return seen[-1]


def bottom_operands(nb: int, dtype, device) -> tuple:
    """K7's operands of the BottomUKF bank's step at bank ``nb``."""
    _, ls, step = bottom_bank(nb, dtype, device)
    return _recorded(bf, "_bottom_step_lanes", lambda: step(ls))


def indirect_operands(nb: int, k: int, dtype, device) -> tuple:
    """K10's operands of the IndirectPoseUKF bank's step at bank ``nb`` with
    ``k`` (1 or 4) corners."""
    _, ls, step = indirect_bank(nb, dtype, device, corners=k)
    return _recorded(ifu, "_indirect_markers_lanes", lambda: step(ls))


def build(csrc: Path, defines: dict) -> subprocess.Popen | Path:
    """The kernels of SOURCES from ``csrc`` with ``defines`` (-D), in the
    build directory under a name hashed from the sources and the defines: the
    path where it is built, else the running ``nvcc``."""
    flags = [*cuda_lib.NVCC_FLAGS, *(f"-D{k}={v}LL" for k, v in defines.items())]
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in sorted(csrc.glob("*.cu*")):
        digest.update(path.name.encode() + path.read_bytes())
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = cuda_lib.BUILD_DIR / f"small_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    cmd = [cuda_lib._nvcc(), *flags, "-shared", "-I", str(csrc), "-o", str(out), *(str(csrc / s) for s in SOURCES)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.out = out
    return proc


def load(built: subprocess.Popen | Path) -> ctypes.CDLL:
    """Wait for a :func:`build` and load it with the current interface's
    argument types."""
    if isinstance(built, subprocess.Popen):
        text = built.communicate()[0]
        if built.returncode:
            raise RuntimeError(f"nvcc failed ({built.returncode}):\n{text[-4000:]}")
        built = built.out
    lib = ctypes.CDLL(str(built))
    for name in ("bottom_step", "indirect_markers"):
        k = cuda_lib.KERNELS[name]
        for suffix in k.suffixes:
            fn = getattr(lib, f"{k.symbol}_{suffix}")
            fn.argtypes, fn.restype = list(k.argtypes), ctypes.c_int
    return lib


@contextlib.contextmanager
def launching(lib: ctypes.CDLL | None):
    """Route the wrappers' launches to ``lib`` (None: the current library)."""
    current = cuda_lib.library()
    if lib is not None:
        cuda_lib._STATE["lib"] = lib
    try:
        yield
    finally:
        cuda_lib._STATE["lib"] = current


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None, help="root of an earlier checkout to time first and last")
    ap.add_argument("--banks", type=int, nargs="+", default=[1, 256, 4096, 8192, 16384, 65536])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--hold", type=int, default=1_000_000, help="spin cycles a launch (default ~0.5 ms)")
    ap.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("small_kernel_times needs an NVIDIA GPU")
    device, dtype = torch.device("cuda", 0), getattr(torch, args.dtype)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    builds = {label: build(cuda_lib.CSRC, dict.fromkeys(SWITCHES, banks)) for label, banks in DESIGNS.items()}
    if args.parent:
        builds["parent"] = build(args.parent / "slam_uwv_kalman_filters_tpu_torch" / "csrc", {})
    cuda_lib.library()
    libs = {label: load(b) for label, b in builds.items()}
    out = {"card": card, "dtype": args.dtype, "parent": str(args.parent), "times": []}
    for nb in args.banks:
        calls = {"bottom_step[predict+range]": (bf.bottom_step_lanes_cuda, bottom_operands(nb, dtype, device))}
        for k in (1, 4):
            calls[f"indirect_markers[k={k}]"] = (ifu.indirect_markers_lanes_cuda,
                                                 indirect_operands(nb, k, dtype, device))
        for name, (fn, fargs) in calls.items():
            order = ["current", *DESIGNS, "current"]
            order = ["parent", *order, "parent"] if args.parent else order
            for label in order:
                with launching(libs.get(label)):
                    ms = device_ms(lambda: fn(*fargs), args.reps, args.hold)
                out["times"].append({"kernel": name, "bank": nb, "build": label, "ms": ms})
                print(f"{name} bank={nb} {label} {args.dtype}: {ms:.5f} ms", flush=True)
        del calls
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Time the small filters' kernels alone on the card: K6 (the VelocityUKF
step: predict + one DVL update), K7 (the BottomUKF step: predict + one
range), K9 (the IndirectPoseUKF predict) and K10 (the IndirectPoseUKF marker
update, 1 and 4 corners). For each kernel: an earlier checkout's build, the
current build (the design it picks for the bank), and each of the current
kernel's designs at every bank, in one process.

This module also defines the three small-filter banks that
``chip_smoke.py`` drives (bench.py's small-filter configurations):
:func:`velocity_bank`, :func:`bottom_bank` and :func:`indirect_bank`. The
operands timed here are recorded from one step of those banks' own entry
points at each bank: for K6 the step predict(0.05) + DVL z = [0.3, 0, 0],
R = 1e-3·I; for K7 predict(0.1) + one range beam (0, 0, −1) from the origin,
z = 0.3, R = 1e-3; for K9 predict(0.1); for K10 the marker update after
predict(0.1), the bank's corner (0.1, 0.1, 0) at pixel (330, 236) and, for 4
corners, three more at ±0.1 m around it 20 px apart.

Each design is the kernel's own source built with the macros that pick its
design set to reach it at every bank (:data:`TIMED`); ``--parent DIR``
builds ``DIR/slam_uwv_kalman_filters_tpu_torch/csrc/<source>`` (the same C
interface) as it is. Each build is one ``nvcc`` of one source, all started
together. All launches go through the same wrappers. Each time is the median
of three rounds of CUDA events over ``--reps`` launches held behind a spin
kernel of ``--hold`` cycles a launch, so the host's time to enqueue each
launch is hidden. The order is parent, current, the designs, current,
parent. Prints one JSON line: the card's name and power limit
(``nvidia-smi``), then per kernel, bank and build the milliseconds a launch.

    python -m slam_uwv_kalman_filters_tpu_torch.tools.small_kernel_times --parent build/parent \\
        --banks 1 256 4096 16384 65536 --kernels velocity_step indirect_predict
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
from slam_uwv_kalman_filters_tpu_torch.models import velocity_fused as vf
from slam_uwv_kalman_filters_tpu_torch.models import velocity_ukf as vu
from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
from slam_uwv_kalman_filters_tpu_torch.ops import dynamics as dyn
from slam_uwv_kalman_filters_tpu_torch.ops import manifolds as mf
from slam_uwv_kalman_filters_tpu_torch.parallel import bank
from slam_uwv_kalman_filters_tpu_torch.tools.pose_step_times import device_ms
from slam_uwv_kalman_filters_tpu_torch.utils.config import CameraConfiguration

ALL = 1 << 62  # a switch bank past every bank


def velocity_setup(nb: int, dtype, device, gen: torch.Generator | None = None):
    """bench.py's small-filter configuration (BASELINE configs[0]): the
    VelocityUKF at rest with thruster efforts [60, 0, 0, 0, 0, 1] on the
    default vehicle; with ``gen``, moved means, correlated covariances,
    efforts, gyro rates and tracker orientations per instance. Returns (bank
    state, params)."""
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)
    mu = vu.VelocityState(velocity=t([0.0, 0.0, 0.0]), z_position=t([0.0]))
    state, params = vu.init(mu, torch.eye(4, dtype=dtype, device=device) * 0.1,
                            bank.tree_map(lambda a: a.to(dtype), dyn.default_uwv_parameters(device=device)))
    state = vu.integrate_body_efforts(state, t([60.0, 0.0, 0.0, 0.0, 0.0, 1.0]))
    bs = bank.replicate(state, nb)
    if gen is not None:
        rn = lambda *shape: torch.randn(*shape, generator=gen, dtype=torch.float64, device=device).to(dtype)
        g = rn(nb, 4, 4)
        av = 0.05 * rn(nb, 3)
        bs = bs._replace(
            mu=vu.VelocityState(0.5 * rn(nb, 3), 2.0 * rn(nb, 1)),
            cov=0.02 * (g @ g.transpose(1, 2) / 4 + torch.eye(4, dtype=dtype, device=device)),
            body_efforts=30.0 * rn(nb, 6), angular_velocity=av,
            model_state=bs.model_state._replace(
                position=rn(nb, 3), orientation=mf.so3_boxplus(bs.model_state.orientation, 0.3 * rn(nb, 3)),
                linear_velocity=0.5 * rn(nb, 3), angular_velocity=av),
        )
        params = params._replace(model=params.model._replace(weight=t(1000.0), cog=t([0.01, -0.02, 0.05])))
    return bs, params


def velocity_bank(nb: int, dtype, device):
    """bench.py's small-filter VelocityUKF (:func:`velocity_setup`) at bank
    ``nb``. Returns (bank state, lanes state, step): the step is
    predict(0.05) + DVL z = [0.3, 0, 0], R = 1e-3·I, one K6 launch."""
    bs, params = velocity_setup(nb, dtype, device)
    z = torch.tensor([0.3, 0.0, 0.0], dtype=dtype, device=device).expand(nb, 3)
    r = torch.eye(3, dtype=dtype, device=device) * 1e-3
    return bs, vf.to_lanes(bs), lambda ls: vf.step_lanes(ls, params, 0.05, [vf.StepUpdate("dvl", z, r)])[0]


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


def velocity_operands(nb: int, dtype, device) -> tuple:
    """K6's operands of the VelocityUKF bank's step at bank ``nb``."""
    _, ls, step = velocity_bank(nb, dtype, device)
    return _recorded(vf, "_velocity_step_lanes", lambda: step(ls))


def bottom_operands(nb: int, dtype, device) -> tuple:
    """K7's operands of the BottomUKF bank's step at bank ``nb``."""
    _, ls, step = bottom_bank(nb, dtype, device)
    return _recorded(bf, "_bottom_step_lanes", lambda: step(ls))


def indirect_predict_operands(nb: int, dtype, device) -> tuple:
    """K9's operands of the IndirectPoseUKF bank's step at bank ``nb``."""
    _, ls, step = indirect_bank(nb, dtype, device)
    return _recorded(ifu, "_indirect_predict_lanes", lambda: step(ls))


def indirect_operands(nb: int, k: int, dtype, device) -> tuple:
    """K10's operands of the IndirectPoseUKF bank's step at bank ``nb`` with
    ``k`` (1 or 4) corners."""
    _, ls, step = indirect_bank(nb, dtype, device, corners=k)
    return _recorded(ifu, "_indirect_markers_lanes", lambda: step(ls))


# label: (kernel, source, wrapper, operands(nb, dtype, device), {design: the macros that reach it at every bank})
TIMED = {
    "velocity_step[predict+dvl]": (
        "velocity_step", "velocity_step.cu", vf.velocity_step_lanes_cuda, velocity_operands,
        {**{f"G={g}": {"SLAM_VELOCITY_GROUP": g, "SLAM_VELOCITY_GROUP_BANKS": ALL} for g in (16, 8, 4, 2)},
         "one thread": {"SLAM_VELOCITY_GROUP_BANKS": 0}}),
    "bottom_step[predict+range]": (
        "bottom_step", "bottom_step.cu", bf.bottom_step_lanes_cuda, bottom_operands,
        {"G=8": {"SLAM_BOTTOM_GROUP_BANKS": ALL}, "one thread": {"SLAM_BOTTOM_GROUP_BANKS": 0}}),
    "indirect_predict": (
        "indirect_predict", "indirect_predict.cu", ifu.indirect_predict_lanes_cuda, indirect_predict_operands,
        {**{f"G={g}": {"SLAM_INDIRECT_PREDICT_GROUP": g, "SLAM_INDIRECT_PREDICT_GROUP_BANKS": ALL}
            for g in (16, 8, 4, 2)},
         "one thread": {"SLAM_INDIRECT_PREDICT_GROUP_BANKS": 0}}),
    **{f"indirect_markers[k={k}]": (
        "indirect_markers", "indirect_markers.cu", ifu.indirect_markers_lanes_cuda,
        lambda nb, dtype, device, k=k: indirect_operands(nb, k, dtype, device),
        {"G=32": {"SLAM_INDIRECT_WIDE_BANKS": ALL}, "G=4": {"SLAM_INDIRECT_WIDE_BANKS": 0}}) for k in (1, 4)},
}


def build(csrc: Path, source: str, defines: dict) -> subprocess.Popen | Path:
    """``source`` of ``csrc`` with ``defines`` (-D), in the build directory
    under a name hashed from the sources and the defines: the path where it
    is built, else the running ``nvcc``."""
    flags = [*cuda_lib.NVCC_FLAGS, *(f"-D{k}={v}LL" for k, v in sorted(defines.items()))]
    digest = hashlib.sha256(" ".join([source, *flags]).encode())
    for path in sorted(csrc.glob("*.cu*")):
        digest.update(path.name.encode() + path.read_bytes())
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = cuda_lib.BUILD_DIR / f"small_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    cmd = [cuda_lib._nvcc(), *flags, "-shared", "-I", str(csrc), "-o", str(out), str(csrc / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.out = out
    return proc


def load(built: subprocess.Popen | Path, kernel: str) -> ctypes.CDLL:
    """Wait for a :func:`build` and load it with ``kernel``'s current
    argument types."""
    if isinstance(built, subprocess.Popen):
        text = built.communicate()[0]
        if built.returncode:
            raise RuntimeError(f"nvcc failed ({built.returncode}):\n{text[-4000:]}")
        built = built.out
    lib = ctypes.CDLL(str(built))
    k = cuda_lib.KERNELS[kernel]
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
    ap.add_argument("--banks", type=int, nargs="+", default=[1, 256, 4096, 16384, 65536])
    ap.add_argument("--kernels", nargs="+", default=sorted({v[0] for v in TIMED.values()}),
                    choices=sorted({v[0] for v in TIMED.values()}))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--hold", type=int, default=1_000_000, help="spin cycles a launch (default ~0.5 ms)")
    ap.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("small_kernel_times needs an NVIDIA GPU")
    device, dtype = torch.device("cuda", 0), getattr(torch, args.dtype)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    timed = {label: v for label, v in TIMED.items() if v[0] in args.kernels}
    builds = {}
    for label, (kernel, source, _, _, designs) in timed.items():
        for design, defines in designs.items():
            builds.setdefault((kernel, design), (source, build(cuda_lib.CSRC, source, defines)))
        if args.parent:
            parent_csrc = args.parent / "slam_uwv_kalman_filters_tpu_torch" / "csrc"
            builds.setdefault((kernel, "parent"), (source, build(parent_csrc, source, {})))
    cuda_lib.library()
    libs = {key: load(b, key[0]) for key, (_, b) in builds.items()}
    out = {"card": card, "dtype": args.dtype, "parent": str(args.parent), "times": []}
    for nb in args.banks:
        for label, (kernel, _, fn, operands, designs) in timed.items():
            fargs = operands(nb, dtype, device)
            order = ["current", *designs, "current"]
            order = ["parent", *order, "parent"] if args.parent else order
            for build_label in order:
                with launching(libs.get((kernel, build_label))):
                    ms = device_ms(lambda: fn(*fargs), args.reps, args.hold)
                out["times"].append({"kernel": label, "bank": nb, "build": build_label, "ms": ms})
                print(f"{label} bank={nb} {build_label} {args.dtype}: {ms:.5f} ms", flush=True)
            del fargs
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

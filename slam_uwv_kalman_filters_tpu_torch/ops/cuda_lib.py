"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

The kernels are CUDA C++ for Hopper (``sm_90a``) with a plain C interface.
At first use :func:`library` compiles every ``csrc/*.cu`` with ``nvcc`` into
one shared library under ``build/kernels/`` (next to the package, named
after a hash of the sources and flags, so an edited source is rebuilt) and
loads it with ``ctypes``. Nothing is built at import time: the CPU tests
import every module, and a machine without ``nvcc`` never needs the build.

Each kernel is a :class:`Kernel`: its C entry points (one per dtype), the
argument types, and a plain integer launch counter that counts launches and
nothing else. A C entry point enqueues its kernel on the stream it is given
and returns ``cudaGetLastError()``; :meth:`Kernel.launch` raises if that is
not ``cudaSuccess``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["Kernel", "KERNELS", "library", "build_info", "host_array", "reset_launch_counts", "stream_ptr"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
# compile flags of each source; the objects are then linked with -shared
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_F64 = ctypes.c_double


class Kernel:
    """One hand-written kernel: C entry points ``<symbol>_f32``/``_f64``
    taking ``argtypes``, the source it lives in and a launch counter."""

    def __init__(self, name: str, symbol: str, source: str, argtypes: tuple):
        self.name = name
        self.symbol = symbol
        self.source = source
        self.argtypes = argtypes
        self.launches = 0

    def launch(self, dtype: torch.dtype, *args) -> None:
        suffix = {torch.float32: "f32", torch.float64: "f64"}.get(dtype)
        if suffix is None:
            raise TypeError(f"{self.name}: no kernel for dtype {dtype}")
        rc = getattr(library(), f"{self.symbol}_{suffix}")(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: cudaError {rc}")
        self.launches += 1


KERNELS = {
    "sigma_deltas": Kernel(
        "sigma_deltas", "slam_sigma_deltas", "csrc/sigma_deltas.cu",
        # a_t, out_t, scratch, n, nb, stream
        (_P, _P, _P, _I32, _I64, _P),
    ),
    "pose_predict": Kernel(
        "pose_predict", "slam_pose_predict", "csrc/pose_predict.cu",
        # cov_t, mu_t, rr_t, coeff, offs, q0m, scal, cov_out, mu_out, y, c, nb, stream
        (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _P),
    ),
    "pose_predict_full": Kernel(
        "pose_predict_full", "slam_pose_predict_full", "csrc/pose_predict.cu",
        # cov_t, mu_t, rr_t, coeff, offs, q0m_t, scal, aux_t, cov_out, mu_out, y, c, nb, stream
        (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _P),
    ),
    "pose_update_model": Kernel(
        "pose_update_model", "slam_pose_update_model", "csrc/pose_update.cu",
        # model, banked_aux, z_t, r_t, mu_t, cov_t, scal, mscal, aux_t,
        # cov_out, mu_out, m2, acc, nu_t, c, zs, cw, nb, stream
        (_I32, _I32, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _P),
    ),
    "pose_update_tail": Kernel(
        "pose_update_tail", "slam_pose_update_tail", "csrc/pose_update_tail.cu",
        # m, deltas_t, dz_t, nu_t, r_t, mu_t, cov_t, thr, cov_out, mu_out, m2, acc, w, nb, stream
        (_I32, _P, _P, _P, _P, _P, _P, _F64, _P, _P, _P, _P, _P, _I64, _P),
    ),
    "pose_step": Kernel(
        "pose_step", "slam_pose_step", "csrc/pose_step.cu",
        # cov_t, mu_t, rr_t, coeff, offs, q0m, scal, n_upd, models*, z**, r**, scal6,
        # m2**, acc**, nu**, cov_out, mu_out, y, c, zs, cw, nb, stream
        (_P, _P, _P, _P, _P, _P, _P, _I32, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
         _I64, _P),
    ),
    "velocity_step": Kernel(
        "velocity_step", "slam_velocity_step", "csrc/velocity_step.cu",
        # do_predict, cov_t, mu_t, eff_t, av_t, trk_t, scal, n_upd, models*, z**, r**,
        # thr* (double), m2**, acc**, nu**, cov_out, mu_out, trk_out, nb, stream
        (_I32, _P, _P, _P, _P, _P, _P, _I32, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _P),
    ),
}


def host_array(ctype, values) -> ctypes.Array:
    """A host array of ``values`` for a kernel's by-value chain argument; pass
    ``ctypes.addressof`` of it and keep it alive until the launch returns
    (the launcher copies it into the kernel's argument struct)."""
    return (ctype * max(1, len(values)))(*values)

_STATE: dict = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    if "lib" in _STATE:
        return _STATE["lib"]
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + headers:
        digest.update(path.name.encode() + path.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libslam_uwv_kernels_{digest.hexdigest()[:16]}.so"
    log = BUILD_DIR / f"{out.stem}.log"
    seconds = 0.0
    if not out.exists():
        # one nvcc per source, in parallel, then one link
        nvcc = _nvcc()
        t0 = time.perf_counter()
        objs = [BUILD_DIR / f"{src.stem}_{out.stem[-16:]}.o" for src in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-I", str(CSRC), "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objs)
        ]
        outputs = [p.communicate()[0] for p in procs]
        log.write_text("\n".join(outputs))
        for src, p, text in zip(sources, procs, outputs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({p.returncode}):\n{text[-4000:]}")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)], capture_output=True, text=True
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr[-4000:]}")
        tmp.rename(out)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    for k in KERNELS.values():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{k.symbol}_{suffix}")
            fn.argtypes = list(k.argtypes)
            fn.restype = ctypes.c_int
    _STATE.update(lib=lib, path=out, log=log, build_seconds=seconds)
    return lib


def build_info() -> dict:
    """Path, compile seconds (0.0 if the library was already built) and the
    ``-Xptxas -v`` log of the loaded library."""
    library()
    log = _STATE["log"]
    return {
        "path": str(_STATE["path"]),
        "build_seconds": _STATE["build_seconds"],
        "ptxas": log.read_text() if log.exists() else "",
    }


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_lanes(name: str, device: torch.device, dtype: torch.dtype, **tensors) -> None:
    """Device, dtype and contiguity checks shared by the kernel wrappers
    (shapes are checked by each wrapper)."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: kernels take float32 or float64, got {dtype}")
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")

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

Each kernel wrapper is also a functional op of the ``slam_uwv`` namespace
(:func:`kernel_op`): its CUDA implementation is the kernel's wrapper, its
CPU implementation the plain version, and its fake gives the outputs'
shapes. The entry points call the wrapper straight; under ``torch.export``
they call the op, so the exported graph records it by name (``utils/aot.py``)
and a CUDA graph of the loaded program captures its launch. Under
``torch.func.vmap`` they call the op too, whose vmap rule (where the kernel
has one: K1, K8, K12) folds the vmapped axes into the kernel's bank axis, so
a function written for one filter makes one launch for the whole bank, as
JAX's ``custom_vmap`` rules do.
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
from torch._C import _functorch

__all__ = ["Kernel", "KERNELS", "KernelOp", "NAMESPACE", "library", "build_info", "chain", "host_array",
           "is_vmapped", "kernel_op", "model_ids", "reset_launch_counts", "route", "stream_ptr"]

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
    """One hand-written kernel: C entry points ``<symbol>_<suffix>`` for each
    of ``suffixes`` (``f32``, ``f64``) taking ``argtypes``, the source it
    lives in and a launch counter. A kernel that sizes its blocks at launch
    also has ``<symbol>_<suffix>_warps`` taking ``warps`` (the sizes), which
    returns the warps per block it would launch with, and one that sizes them
    by occupancy (``resident``) also ``<symbol>_<suffix>_resident``, the
    warps an SM keeps at that size."""

    def __init__(self, name: str, symbol: str, source: str, argtypes: tuple, suffixes=("f32", "f64"),
                 warps: tuple | None = None, resident: bool = False):
        self.name = name
        self.symbol = symbol
        self.source = source
        self.argtypes = argtypes
        self.suffixes = suffixes
        self.warps = warps
        self.resident = resident
        self.launches = 0

    def launch(self, dtype: torch.dtype, *args) -> None:
        suffix = {torch.float32: "f32", torch.float64: "f64"}.get(dtype)
        if suffix not in self.suffixes:
            raise TypeError(f"{self.name}: no kernel for dtype {dtype}")
        rc = getattr(library(), f"{self.symbol}_{suffix}")(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: cudaError {rc}")
        self.launches += 1

    def warps_per_block(self, dtype: torch.dtype, *sizes) -> int:
        """The warps per block a launch at ``sizes`` would use (no launch)."""
        suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
        got = getattr(library(), f"{self.symbol}_{suffix}_warps")(*sizes)
        if got < 1:
            raise RuntimeError(f"{self.name}: no block size for {sizes}: cudaError {-got}")
        return got

    def resident_warps(self, dtype: torch.dtype, *sizes) -> int:
        """The warps an SM keeps resident at the block size of a launch at
        ``sizes`` (the occupancy calculator's answer; no launch)."""
        if not self.resident:
            raise TypeError(f"{self.name} has no resident-warps entry")
        suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
        got = getattr(library(), f"{self.symbol}_{suffix}_resident")(*sizes)
        if got < 1:
            raise RuntimeError(f"{self.name}: no block size for {sizes}: cudaError {-got}")
        return got


KERNELS = {
    "sigma_deltas": Kernel(
        "sigma_deltas", "slam_sigma_deltas", "csrc/sigma_deltas.cu",
        # a and its (bank, row, col) strides, out and its strides, n, nb, stream
        (_P, _I64, _I64, _I64, _P, _I64, _I64, _I64, _I32, _I64, _P),
    ),
    "pose_predict": Kernel(
        "pose_predict", "slam_pose_predict", "csrc/pose_predict.cu",
        # cov_t, mu_t, rr_t, coeff, offs, q0m, scal, cov_out, mu_out, nb, stream
        (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _P),
        warps=(_I64,), resident=True,  # nb
    ),
    "pose_predict_full": Kernel(
        "pose_predict_full", "slam_pose_predict_full", "csrc/pose_predict.cu",
        # cov_t, mu_t, rr_t, coeff, offs, q0m_t, scal, aux_t, cov_out, mu_out, nb, stream
        (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _P),
        warps=(_I64,), resident=True,  # nb
    ),
    "pose_update_model": Kernel(
        "pose_update_model", "slam_pose_update_model", "csrc/pose_update.cu",
        # model, banked_aux, z_t, r_t, mu_t, cov_t, scal, mscal, aux_t,
        # cov_out, mu_out, m2, acc, nu_t, nb, stream
        (_I32, _I32, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _P),
        warps=(_I32, _I64),  # model, nb
    ),
    "pose_update_tail": Kernel(
        "pose_update_tail", "slam_pose_update_tail", "csrc/pose_update_tail.cu",
        # m, deltas_t, dz_t, nu_t, r_t, mu_t, cov_t, thr, cov_out, mu_out, m2, acc, nb, stream
        (_I32, _P, _P, _P, _P, _P, _P, _F64, _P, _P, _P, _P, _I64, _P),
        warps=(_I32, _I64), resident=True,  # m, nb
    ),
    "pose_step": Kernel(
        "pose_step", "slam_pose_step", "csrc/pose_step.cu",
        # cov_t, mu_t, rr_t, coeff, offs, q0m, scal, n_upd, models*, z**, r**, scal6,
        # m2**, acc**, nu**, cov_out, mu_out, nb, stream
        (_P, _P, _P, _P, _P, _P, _P, _I32, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _P),
        warps=(_I64,), resident=True,  # nb
    ),
    "velocity_step": Kernel(
        "velocity_step", "slam_velocity_step", "csrc/velocity_step.cu",
        # do_predict, cov_t, mu_t, eff_t, av_t, trk_t, scal, n_upd, models*, z**, r**,
        # thr* (double), m2**, acc**, nu**, cov_out, mu_out, trk_out, nb, stream
        (_I32, _P, _P, _P, _P, _P, _P, _I32, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _P),
        warps=(_I64,), resident=True,  # nb (the predicting launch)
    ),
    "bottom_step": Kernel(
        "bottom_step", "slam_bottom_step", "csrc/bottom_step.cu",
        # do_predict, cov_t, mu_t, vel_t, dt (double), q9* (double), n_upd, models*, z**, r**,
        # dir**, org**, thr* (double), m2**, acc**, nu**, cov_out, mu_out, nb, stream
        (_I32, _P, _P, _P, _F64, _P, _I32, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _P),
        warps=(_I64,), resident=True,  # nb
    ),
    "solve_spd": Kernel(
        "solve_spd", "slam_solve_spd", "csrc/solve_spd.cu",
        # a, b, x, each followed by its (bank, row, col) strides, n, k, nb, stream
        (_P, _I64, _I64, _I64, _P, _I64, _I64, _I64, _P, _I64, _I64, _I64, _I32, _I32, _I64, _P),
    ),
    "indirect_predict": Kernel(
        "indirect_predict", "slam_indirect_predict", "csrc/indirect_predict.cu",
        # cov_t, mu_t, scal, cov_out, mu_out, nb, stream
        (_P, _P, _P, _P, _P, _I64, _P),
        warps=(_I64,), resident=True,  # nb
    ),
    "indirect_markers": Kernel(
        "indirect_markers", "slam_indirect_markers", "csrc/indirect_markers.cu",
        # cov_t, mu_t, ref_t, mk_t, z_t, r_t, scal, k, cov_out, mu_out, m2, nu_t, nb, stream
        (_P, _P, _P, _P, _P, _P, _P, _I32, _P, _P, _P, _P, _I64, _P),
        warps=(_I64,), resident=True,  # nb
    ),
    "pose_markers": Kernel(
        "pose_markers", "slam_pose_markers", "csrc/pose_markers.cu",
        # cov_t, mu_t, mk_t, z_t, r_t, scal, k, cov_out, mu_out, m2, nu_t, nb, stream
        (_P, _P, _P, _P, _P, _P, _I32, _P, _P, _P, _P, _I64, _P),
        warps=(_I64,), resident=True,  # nb
    ),
    "cholesky": Kernel(
        "cholesky", "slam_cholesky", "csrc/cholesky.cu",
        # a and its (bank, row, col) strides, out and its strides, n, nb, stream
        (_P, _I64, _I64, _I64, _P, _I64, _I64, _I64, _I32, _I64, _P),
        warps=(_I32, _I64),  # n, nb
    ),
    "fma_probe": Kernel(
        "fma_probe", "slam_fma_probe", "csrc/fma_probe.cu",
        # a, b, out, n, stream
        (_P, _P, _P, _I64, _P), suffixes=("f32",),
    ),
}


NAMESPACE = "slam_uwv"


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for leaf in tree:
            yield from _tensors(leaf)


def _fresh_outputs(fn):
    """``fn`` with its outputs as the kernels give theirs: contiguous, and
    never an input's storage (an op's outputs may not alias its inputs, and
    a plain version may pass an operand through unchanged)."""

    def call(*args):
        held = {t.untyped_storage().data_ptr() for t in _tensors(args) if t.numel()}

        def fresh(tree):
            if isinstance(tree, torch.Tensor):
                if tree.numel() and tree.untyped_storage().data_ptr() in held:
                    return tree.clone(memory_format=torch.contiguous_format)
                return tree.contiguous()
            if isinstance(tree, (tuple, list)):
                return type(tree)(fresh(leaf) for leaf in tree)
            return tree

        return fresh(fn(*args))

    return call


def _call(op, *args):
    return op(*args)


def is_vmapped(*tree) -> bool:
    """True where a tensor of ``tree`` (nested tuples and lists) is batched
    by ``torch.func.vmap``: such a tensor has no storage of its own, and the
    code that handles it may neither read it on the host nor write it into
    an unbatched tensor. Outside any functorch transform it costs one C call
    and reads no tensor."""
    if _functorch.maybe_current_level() is None:
        return False
    return any(_functorch.is_batchedtensor(t) for t in _tensors(tree))


class KernelOp:
    """A kernel wrapper and its op ``slam_uwv::<name>`` (:func:`kernel_op`).
    Called eagerly it goes straight to the wrapper when ``args[lead]`` is a
    CUDA tensor and to the plain version otherwise, with no dispatcher in
    between: the op's Python dispatch costs each call about 80 µs of host
    (K5 at bank 1 on an H100 80GB HBM3 host, ``chip_smoke.phase_op_dispatch``).
    Under ``torch.export`` it calls the op through ``adapt``, so the graph
    records it by name; a loaded program then calls the op on either
    device. Under ``torch.func.vmap`` (a batched tensor among the
    arguments) it calls the op too, whose vmap rule folds the vmapped axes
    into one call of this :class:`KernelOp` on the unbatched level; an op
    with no rule raises ``NotImplementedError`` there, since its wrapper
    cannot read a batched tensor and a loop over instances would not be the
    kernel. ``op`` is the op's overload."""

    __slots__ = ("op", "cuda", "plain", "lead", "adapt", "vmap")

    def __init__(self, op, cuda, plain, lead: int = 0, adapt=_call, vmap=None):
        self.op, self.cuda, self.plain, self.lead, self.adapt, self.vmap = op, cuda, plain, lead, adapt, vmap

    def __call__(self, *args):
        if torch.compiler.is_exporting():
            return self.adapt(self.op, *args)
        if is_vmapped(args):
            if self.vmap is None:
                raise NotImplementedError(f"{self.op._schema.name}: this kernel has no vmap rule; call its bank "
                                          "form on the stacked operands")
            return self.adapt(self.op, *args)
        return (self.cuda if args[self.lead].is_cuda else self.plain)(*args)


def kernel_op(name: str, schema: str, cuda, plain, fake, *, lead: int = 0, impl=None, adapt=_call,
              vmap=None) -> KernelOp:
    """Register a kernel wrapper as the functional op ``slam_uwv::<name>``
    (``torch.library.custom_op``) and return it as a :class:`KernelOp`.
    ``cuda`` launches the kernel on CUDA tensors and ``plain`` is its plain
    version for CPU tensors, both taking the entry point's arguments, the
    tensor ``args[lead]`` choosing between them. Where the schema takes
    other types (model ids for names, lists for the per-update triples,
    floats), ``impl(fn)`` turns either into the op's implementation and
    ``adapt(op, *args)`` calls the op with the entry point's arguments and
    returns what ``fn`` returns (:func:`model_ids`, :func:`chain`). ``fake``
    returns empty outputs of exactly the shapes, dtypes and strides the op's
    CUDA implementation returns. The op's outputs are fresh tensors, never
    an input's, so export needs no copy. ``vmap(call, in_dims, *args)``,
    where given, is the op's vmap rule: it gets the arguments of one vmap
    level unwrapped with their batch dims (``None`` for an unbatched one)
    and returns ``(output, out_dims)``, computing the output by one
    ``call(*folded)`` of the returned :class:`KernelOp` (the kernel's bank
    form, one level down). The kernel wrappers count their launches; the op
    adds nothing to the counts."""
    impl = impl or (lambda fn: fn)
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", _fresh_outputs(impl(plain)), mutates_args=(),
                                 device_types="cpu", schema=schema)
    op.register_kernel("cuda", impl(cuda))
    op.register_fake(fake)
    kop = KernelOp(op._opoverload, cuda, plain, lead, adapt, vmap)
    if vmap is not None:
        op.register_vmap(lambda info, in_dims, *args: vmap(kop, in_dims, *args))
    return kop


def model_ids(names: tuple) -> dict:
    """``kernel_op``'s ``impl`` and ``adapt`` for a kernel whose first
    argument names its model (K3): the op takes the name's index in
    ``names`` (an op's schema has no strings)."""
    ids = {n: i for i, n in enumerate(names)}
    return {"impl": lambda fn: lambda model, *args: fn(names[model], *args),
            "adapt": lambda op, model, *args: op(ids[model], *args)}


def chain(names: tuple, cast=lambda *args: args) -> dict:
    """``kernel_op``'s ``impl`` and ``adapt`` for a whole-step kernel (K5,
    K6, K7): its first argument, the chain's model names, travels as their
    indices in ``names``, ``cast`` gives the other arguments the schema's
    types, and the per-update (m2, acc, nu_t) triples travel as three
    lists."""
    ids = {n: i for i, n in enumerate(names)}

    def impl(fn):
        def call(models, *args):
            *head, infos = fn(tuple(names[m] for m in models), *args)
            return (*head, *([info[k] for info in infos] for k in range(3)))

        return call

    def adapt(op, models, *args):
        *head, m2s, accs, nus = op([ids[m] for m in models], *cast(*args))
        return (*head, list(zip(m2s, accs, nus)))

    return {"impl": impl, "adapt": adapt}


def route(name: str, t: torch.Tensor) -> None:
    """Raise unless ``t`` lies on a device the kernel ops serve (CUDA: the
    kernel, CPU: its plain version)."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: no path for device {t.device}")


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
        for suffix in k.suffixes:
            fn = getattr(lib, f"{k.symbol}_{suffix}")
            fn.argtypes = list(k.argtypes)
            fn.restype = ctypes.c_int
            for entry in ["warps"] * bool(k.warps) + ["resident"] * k.resident:
                fn = getattr(lib, f"{k.symbol}_{suffix}_{entry}")
                fn.argtypes = list(k.warps)
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


def check_lanes(name: str, device: torch.device, dtype: torch.dtype, contiguous: bool = True, **tensors) -> None:
    """Device, dtype and (unless ``contiguous`` is False, for a kernel that
    takes strides) contiguity checks shared by the kernel wrappers (shapes
    are checked by each wrapper)."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: kernels take float32 or float64, got {dtype}")
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")

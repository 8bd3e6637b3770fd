"""Exported filter steps: a step shipped as bytes, replayed as a CUDA graph.

Counterpart of ``slam_uwv_kalman_filters_tpu/utils/aot.py``. A vehicle host
should run a mission loop with none of the model's Python in it: the step is
traced once, at integration time, by ``torch.export`` into a graph of ATen
operations and of the port's kernels (each kernel wrapper is the op
``slam_uwv::<name>``, registered by ``ops.cuda_lib.kernel_op``, so the graph
records it by name on the CPU as on the card), saved to bytes, and on the
vehicle loaded and called.

* :func:`export_step` flattens the example arguments (``torch.utils._pytree``)
  and exports a module that takes the tensor leaves, rebuilds the arguments
  and calls ``fn``; the tree specs of the inputs and outputs are kept, so the
  loaded step takes and returns the same NamedTuples as ``fn``. Tensors that
  ``fn`` closes over (the filter's parameters) become the artifact's
  constants. The iterative means run all their iterations under export (no
  host read), and ``utils.memo`` keeps no block built while tracing.
* :func:`serialize` writes the ``torch.export.save`` archive with the tree
  specs as one of its extra files, each NamedTuple named by its import path.
* :func:`deserialize` and :func:`load` import the port's op registrations,
  load the program and return a callable. On the card its first call warms
  the program up on a side stream (the kernel library is built and loaded
  there), then captures it into a CUDA graph on static input buffers; every
  call copies its inputs into those buffers, replays the graph and returns
  clones of its outputs, so a returned state never changes under the
  caller. On the CPU the callable runs the loaded program. A call whose
  shapes or dtypes differ from the export raises, and so does loading an
  artifact exported on the card on a machine without one.

There is no ``allow_tpu_kernels``: the kernels are the port's own ops. An
artifact is specific to the device it was exported on, to the argument
shapes and dtypes, and to the PyTorch version that wrote it. The kernels'
launch counters (``cuda_lib.KERNELS[...].launches``) count host calls: the
warm-up and the capture move them, a replay does not. The callable counts
its ``captures`` and ``replays`` instead.
"""

from __future__ import annotations

import importlib
import io
import json
import time
import zipfile
from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

__all__ = ["Exported", "ExportedStep", "export_step", "serialize", "deserialize", "save", "load"]

# the modules whose import registers the kernel ops an exported step may call
_OP_MODULES = (
    "ops.kernels", "models.pose_fused", "models.pose_update_fused", "models.velocity_fused",
    "models.bottom_fused", "models.indirect_fused", "models.pose_marker_fused",
)
_HEADER = "slam_uwv_step.json"


class Exported(NamedTuple):
    """An exported step: the program over the tensor leaves of the
    arguments and the trees around it."""

    program: torch.export.ExportedProgram
    header: dict  # device, tree specs, NamedTuple paths, constant leaves, input shapes and dtypes


def _is_namedtuple(cls) -> bool:
    return isinstance(cls, type) and issubclass(cls, tuple) and hasattr(cls, "_fields")


def _namedtuples(spec: pytree.TreeSpec, found: dict) -> dict:
    """The NamedTuple classes in ``spec`` by import path (a class flattened
    before its registration is the node's context, after it its type)."""
    for cls in (spec.type, spec.context):
        if _is_namedtuple(cls):
            found[f"{cls.__module__}.{cls.__qualname__}"] = cls
    for child in spec.children():
        _namedtuples(child, found)
    return found


def _register(path: str, cls: type) -> None:
    """Name ``cls`` by its import path for tree-spec serialization (once),
    as the JAX package's ``_register_namedtuples`` names them."""
    if cls not in pytree.SUPPORTED_SERIALIZED_TYPES:
        pytree._register_namedtuple(cls, serialized_type_name=path)


def _import(path: str) -> type:
    module, _, qualname = path.rpartition(".")
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _constant(value):
    if value is not None and not isinstance(value, (bool, int, float, str)):
        raise TypeError(f"export_step: a non-tensor leaf must be a plain number, string or None, got {type(value)}")
    return value


def export_step(fn: Callable, *example_args: Any) -> Exported:
    """Trace ``fn(*example_args)`` with ``torch.export`` (non-strict) on the
    device of the example tensors. Tensor leaves of the arguments become the
    program's inputs; other leaves are fixed at their example values, and a
    call with others raises."""
    for path, cls in _namedtuples(pytree.tree_structure(example_args), {}).items():
        _register(path, cls)
    flat, in_spec = pytree.tree_flatten(example_args)
    tensor_at = [i for i, x in enumerate(flat) if isinstance(x, torch.Tensor)]
    consts = {i: _constant(x) for i, x in enumerate(flat) if not isinstance(x, torch.Tensor)}
    devices = {flat[i].device.type for i in tensor_at}
    if len(devices) > 1:
        raise ValueError(f"export_step: example tensors on several devices {sorted(devices)}")
    out = {}

    class Step(torch.nn.Module):
        def forward(self, *tensors):
            leaves = list(flat)
            for i, t in zip(tensor_at, tensors):
                leaves[i] = t
            out_flat, out["spec"] = pytree.tree_flatten(fn(*pytree.tree_unflatten(leaves, in_spec)))
            out["consts"] = {j: _constant(v) for j, v in enumerate(out_flat) if not isinstance(v, torch.Tensor)}
            return tuple(v for v in out_flat if isinstance(v, torch.Tensor))

    program = torch.export.export(Step(), tuple(flat[i] for i in tensor_at), strict=False)
    paths = {**_namedtuples(in_spec, {}), **_namedtuples(out["spec"], {})}
    for path, cls in paths.items():
        _register(path, cls)
    header = {
        "device": devices.pop() if devices else "cpu",
        "in_spec": pytree.treespec_dumps(in_spec),
        "out_spec": pytree.treespec_dumps(out["spec"]),
        "namedtuples": sorted(paths),
        "in_consts": [[i, v] for i, v in consts.items()],
        "out_consts": [[j, v] for j, v in out["consts"].items()],
        "inputs": [[list(flat[i].shape), str(flat[i].dtype)] for i in tensor_at],
    }
    return Exported(program, header)


def serialize(exported: Exported) -> bytes:
    """The ``torch.export.save`` archive of the program, the trees in it."""
    buf = io.BytesIO()
    torch.export.save(exported.program, buf, extra_files={_HEADER: json.dumps(exported.header)})
    return buf.getvalue()


class ExportedStep:
    """A loaded step: call it as ``fn`` was called. On the card the first
    call captures a CUDA graph and every call replays it (``captures``,
    ``replays``, ``capture_s``: the warm-up and capture seconds); on the CPU
    it runs the program."""

    def __init__(self, module: torch.nn.Module, header: dict):
        self.module = module
        self.device = torch.device(header["device"])
        self.in_spec = pytree.treespec_loads(header["in_spec"])
        self.out_spec = pytree.treespec_loads(header["out_spec"])
        self.in_consts = {i: v for i, v in header["in_consts"]}
        self.out_consts = {j: v for j, v in header["out_consts"]}
        self.inputs = [(tuple(shape), getattr(torch, dtype.split(".")[-1])) for shape, dtype in header["inputs"]]
        self.graph = None
        self.captures = self.replays = 0
        self.capture_s = 0.0

    def _tensors(self, args) -> list:
        flat, spec = pytree.tree_flatten(args)
        if spec != self.in_spec:
            raise ValueError(f"exported step: the arguments' tree differs from the export's:\n{spec}\nvs\n{self.in_spec}")
        tensors = []
        for i, x in enumerate(flat):
            if i in self.in_consts:
                if isinstance(x, torch.Tensor) or x != self.in_consts[i]:
                    raise ValueError(f"exported step: leaf {i} is {x!r}; the export fixed it at {self.in_consts[i]!r}")
                continue
            shape, dtype = self.inputs[len(tensors)]
            if not isinstance(x, torch.Tensor) or tuple(x.shape) != shape or x.dtype != dtype:
                got = (tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor) else type(x)
                raise ValueError(f"exported step: input {len(tensors)} is {got}; the export takes {(shape, dtype)}")
            tensors.append(x)
        return tensors

    def _capture(self, tensors: list) -> None:
        t0 = time.perf_counter()
        self.static_in = [torch.empty(t.shape, dtype=t.dtype, device=self.device).copy_(t) for t in tensors]
        here = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(here)
        with torch.cuda.stream(side):
            self.module(*self.static_in)  # warm-up: the kernel library is built and loaded here
        here.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.static_out = list(self.module(*self.static_in))
        self.graph = graph
        self.captures += 1
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0

    def __call__(self, *args):
        tensors = self._tensors(args)
        if self.device.type == "cuda":
            if self.graph is None:
                self._capture(tensors)
            for buf, t in zip(self.static_in, tensors):
                buf.copy_(t)
            self.graph.replay()
            self.replays += 1
            outs = [o.clone() for o in self.static_out]
        else:
            outs = list(self.module(*tensors))
        n = len(outs) + len(self.out_consts)
        leaves = [self.out_consts[j] if j in self.out_consts else outs.pop(0) for j in range(n)]
        return pytree.tree_unflatten(leaves, self.out_spec)


def deserialize(blob: bytes) -> ExportedStep:
    """Bytes → a callable running the exported step (no model code)."""
    for name in _OP_MODULES:
        importlib.import_module(f"{__package__.rpartition('.')[0]}.{name}")
    with zipfile.ZipFile(io.BytesIO(blob)) as archive:
        name = next((n for n in archive.namelist() if n.endswith(f"extra/{_HEADER}")), None)
        if name is None:
            raise ValueError("not an exported step: the archive has no step header")
        header = json.loads(archive.read(name))
    if header["device"] == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this step was exported on a CUDA device and this machine has none; "
                           "export it again on the CPU to run it here")
    program = torch.export.load(io.BytesIO(blob))
    for path in header["namedtuples"]:
        _register(path, _import(path))
    return ExportedStep(program.module(), header)


def save(path: str, exported: Exported) -> None:
    with open(path, "wb") as f:
        f.write(serialize(exported))


def load(path: str) -> ExportedStep:
    with open(path, "rb") as f:
        return deserialize(f.read())

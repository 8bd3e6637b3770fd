"""Counts shared by the work stages: the PoseUKF's sizes, the exact counts
of the dense matrix steps every stage repeats, and an operation counter
that reads the per-point and per-vehicle formulas off the plain reference
(``portbench/reference``), so that no count of a nonlinear function is an
estimate.

The counter runs a reference function once, on the CPU, on one vehicle in
float64, and adds up its ATen operations by name: an elementwise operation
(a comparison or a select included) counts one per output element, a
reduction one per input element, a cross product three per output
element, a product of matrices 2·m·n·k; copies, views and new tensors
count nothing. An operation it has no rule for raises, so a reference
that comes to use one cannot be counted short unseen."""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

N = 53  # tangent dimension
STORAGE = 54  # storage rows of the mean
POINTS = 2 * N + 1  # sigma points
HALF = N * (N + 1) // 2  # entries of a covariance's valid half
F32_TOL = 2.0**-23  # the iterative mean's step at float32's resolution

_POINTWISE = {"abs", "add", "add_", "sub", "sub_", "rsub", "mul", "mul_", "div", "div_", "neg", "reciprocal",
              "sqrt", "rsqrt", "pow", "square", "exp", "log", "sin", "cos", "tan", "atan", "atan2", "asin", "acos",
              "tanh", "sign", "floor", "ceil", "round", "fmod", "remainder", "minimum", "maximum", "clamp",
              "clamp_min", "clamp_max", "where", "lt", "le", "gt", "ge", "eq", "ne", "bitwise_and", "bitwise_or",
              "bitwise_not", "logical_and", "logical_or", "logical_not"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "any", "all", "linalg_vector_norm", "norm"}
_FREE = {"view", "_unsafe_view", "reshape", "expand", "permute", "transpose", "t", "unsqueeze", "squeeze",
         "select", "slice", "unbind", "split", "split_with_sizes", "narrow", "alias", "diagonal", "as_strided",
         "cat", "stack", "clone", "copy_", "_to_copy", "to", "contiguous", "detach", "lift_fresh", "zeros",
         "zeros_like", "ones", "ones_like", "full", "full_like", "empty", "empty_like", "new_zeros", "new_ones",
         "new_empty", "new_full", "scalar_tensor", "index", "index_put_", "index_put", "constant_pad_nd", "fill_",
         "zero_", "_local_scalar_dense", "diag_embed", "diag", "tril", "triu", "arange", "eye", "flip",
         "repeat", "expand_as", "resize_", "set_", "_reshape_alias", "index_select", "gather", "masked_fill",
         "item", "is_nonzero", "alias_copy", "empty_strided"}


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else 0


def _first_tensor(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x
        if isinstance(x, (list, tuple)):
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        first = _first_tensor(out if isinstance(out, (list, tuple)) else [out])
        if name in ("mm", "bmm", "matmul", "mv", "dot"):
            self.ops += 2.0 * _numel(out) * args[0].shape[-1]
        elif name == "linalg_cross":
            self.ops += 3.0 * _numel(out)
        elif name in _REDUCTIONS:
            self.ops += float(_numel(args[0]))
        elif name in _POINTWISE:
            self.ops += float(_numel(first))
        elif name not in _FREE:
            raise NotImplementedError(f"no operation count for aten.{name}")
        return out


def count_ops(fn, *args, **kwargs) -> tuple:
    """(operations, result) of ``fn(*args, **kwargs)`` (module notes)."""
    with torch.no_grad(), _Counter() as c:
        result = fn(*args, **kwargs)
    return c.ops, result


def representative(config: dict, mix: dict):
    """The reference's (mean, covariance, parameters, gyro rate) of one
    vehicle at the cell's start: the configured state at the origin, level,
    with the mix's initial covariance (float64, CPU)."""
    from portbench.reference import pose_ukf as ref

    f64 = torch.float64
    cfg = config["filter"]
    vehicle = ref.vehicle_from(config["vehicle"], f64, "cpu")
    mu = ref.initial_mean(cfg, vehicle, torch.zeros(1, 3, dtype=f64), torch.tensor([[1.0, 0.0, 0.0, 0.0]], dtype=f64))
    cov = ref.initial_cov(cfg, mix["start"]["pos_var"], mix["start"]["rot_var"], f64, "cpu")[None]
    params = ref.make_params(cfg, config["vehicle"], mix["dt"], f64, "cpu")
    return mu, cov, params, torch.zeros(1, 3, dtype=f64)


def factor_ops() -> float:
    """The equilibrated Cholesky factor of the covariance: n³/3 for the
    factor, 2n² for D⁻¹PD⁻¹ and the scaling back."""
    return N**3 / 3 + 2 * N * N


def sigma_points(mu, cov) -> tuple:
    """(operations, the 107 points): μ ⊞ δ, counted off the reference; the
    deltas (± the factor's columns) are the factor's, counted apart."""
    from portbench.reference import pose_ukf as ref

    deltas = ref.sigma_deltas(cov)
    return count_ops(ref.boxplus, mu[None], deltas)


def itemsize(dtype) -> int:
    return {"torch.float32": 4, "torch.float64": 8}[str(dtype)]


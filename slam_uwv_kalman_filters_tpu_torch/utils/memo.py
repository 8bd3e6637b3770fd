"""Kernel operands built from a parameter set, kept for the next call.

The whole-step kernels read a small block derived from the filter's
parameters and dt (K2/K5's shared-mode predict operands, K6's 165-scalar
block). Building one costs tens of small launches, and a loop passes the
same parameters and dt tick after tick. :func:`last_operands` keeps the
last block a builder made and hands it back while its inputs are unchanged,
so the caller passes only parameters and dt and nothing can fall out of
step.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["last_operands"]


def _versions(tree) -> tuple:
    """Version counters of the tensor leaves of a (nested) tuple, in order;
    an in-place write to a leaf, or to a view of it, moves its counter."""
    if isinstance(tree, torch.Tensor):
        return (tree._version,)
    if isinstance(tree, tuple):
        return tuple(v for leaf in tree for v in _versions(leaf))
    return ()


def last_operands(build):
    """Wrap ``build(params, dt, dtype)`` so that a call with the same
    parameter object, dt and dtype as the call before, with no tensor of the
    parameters written since, returns the operands built then. The memo holds
    the parameter object itself, so its identity cannot pass to another
    object. Callers read the operands and never write them."""
    memo: dict = {}

    @functools.wraps(build)
    def wrapper(params, dt, dtype):
        key = (float(dt), dtype, _versions(params))
        if memo.get("params") is params and memo["key"] == key:
            return memo["out"]
        memo.clear()
        out = build(params, dt, dtype)
        memo.update(params=params, key=key, out=out)
        return out

    return wrapper
